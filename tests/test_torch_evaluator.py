"""The port's ``Evaluator`` against the JAX package's on the CPU.

Both sides get the same weights (``flax_to_state_dict``), dropout keep 1.0
(JAX and torch draw different random bits) and the same proxies: the JAX
``downsample_to_proxy`` takes ``cv2.resize`` when ``cv2`` is installed (no
antialiasing) and the port's is always antialiased, so plans are compared
through ``plan_trajectory(low_res_batch)``, and ``eval`` with the JAX
module's ``downsample_to_proxy`` replaced by the port's for the test.

Tolerances: ids, ``applied`` and ``active_mask`` equal; pdfs, params and
proxy images within 1e-5; retouched images within atol 3e-5 / rtol 1e-4
with at most 1e-4 of the values outside (S+ at exact gray moves a value by
about 25 LSB between two correct chains); ``u8`` replay within 1 LSB of the
float32 replay on the u8 grid."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exposure_tpu.core.evaluator as jev
from exposure_tpu.core.rollout import Trajectory as JTrajectory
from exposure_tpu.core.trainer import build_models as j_build_models
from exposure_tpu.core.trainer import init_train_state
from exposure_tpu.tools import edit_sequence as j_edit
from exposure_tpu.tools import pickle_to_tex as j_tex
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu.utils.ops import STATE_STOPPED_DIM
from exposure_tpu_torch.core import evaluator as tev
from exposure_tpu_torch.core.artifacts import flax_to_state_dict
from exposure_tpu_torch.core.rollout import Trajectory as TTrajectory
from exposure_tpu_torch.models.networks import build_models as t_build_models
from exposure_tpu_torch.tools import edit_sequence as t_edit
from exposure_tpu_torch.tools import pickle_to_tex as t_tex
from exposure_tpu_torch.utils.config import load_config as t_load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, 'docs', 'sample_inputs', 'masked0.png')
F32_ATOL, F32_RTOL, MAX_OUTLIER_FRAC = 3e-5, 1e-4, 1e-4
ARTIFACT_SET = ('.linear.png', '.input_tone_mapped.png', '.retouched.png',
                '.steps.png', '_debug.pkl')


def _pair(name, seed=0):
    """A JAX and a port evaluator of config ``name`` on the same random
    weights, dropout off."""
    jcfg = j_load_config(name).copy()
    jcfg.dropout_keep_prob = 1.0
    jcfg.name = name + '/none'
    _, policy, critic, value = j_build_models(jcfg)
    state, _ = init_train_state(jcfg, policy, critic, value, seed)
    tcfg = t_load_config(name)
    tcfg.dropout_keep_prob = 1.0
    tcfg.name = jcfg.name
    _, tpolicy, _, _ = t_build_models(tcfg)
    tpolicy.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.gen_params)))
    return types.SimpleNamespace(
        j=jev.Evaluator(jcfg, state=state),
        t=tev.Evaluator(tcfg, policy=tpolicy, device='cpu'))


@pytest.fixture(scope='module')
def pair():
    return _pair('test')


@pytest.fixture(scope='module')
def masked_pair():
    return _pair('masked', seed=3)


def _close_images(got, want):
    bad = ~np.isclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    assert bad.mean() <= MAX_OUTLIER_FRAC, (
        '%.2e of the values differ, max %.3e'
        % (bad.mean(), np.abs(got - want).max()))


def _stop_traj(cls, stopped_flags):
    """A trajectory whose stop flag after each step is given, [K][B]."""
    k, b = len(stopped_flags), len(stopped_flags[0])
    states = np.zeros((k, b, 11), np.float32)
    for i in range(k):
        states[i, :, STATE_STOPPED_DIM] = stopped_flags[i]
    fields = dict(
        images=np.zeros((k, b, 4, 4, 3), np.float32), states=states,
        filter_ids=np.zeros((k, b), np.int32),
        params=np.zeros((k, b, 24), np.float32),
        mask_params=np.zeros((k, b, 6), np.float32),
        pdfs=np.zeros((k, b, 8), np.float32),
        surrogates=np.zeros((k, b, 1), np.float32),
        final_image=np.zeros((b, 4, 4, 3), np.float32),
        final_state=states[-1])
    return cls(**fields)


# the five cases of tests/test_evaluator_mask.py: flags, mask, applied
STOP_CASES = {
    'no_stop_all_active': ([[0], [0], [0]], [[1], [1], [1]], [3]),
    'stop_after_second_step': ([[0], [1], [1]], [[1], [1], [0]], [2]),
    'stop_at_first_step': ([[1], [1], [1]], [[1], [0], [0]], [1]),
    'per_sample_independent': ([[0, 1], [1, 1], [1, 1]],
                               [[1, 1], [1, 0], [0, 0]], [2, 1]),
    'applied_counts': ([[0, 1, 0], [1, 1, 0], [1, 1, 0]],
                       [[1, 1, 1], [1, 0, 1], [0, 0, 1]], [2, 1, 3]),
}


@pytest.mark.parametrize('case', sorted(STOP_CASES))
@pytest.mark.parametrize('as_tensor', [False, True])
def test_active_mask_and_applied(pair, case, as_tensor, monkeypatch):
    flags, want_mask, want_applied = STOP_CASES[case]
    traj = _stop_traj(TTrajectory, flags)
    if as_tensor:
        traj = TTrajectory(*(torch.from_numpy(x) for x in traj))
    got = pair.t.active_mask(traj)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want_mask)
    np.testing.assert_array_equal(
        got, np.asarray(pair.j.active_mask(_stop_traj(JTrajectory, flags))))
    # applied, through plan_trajectory with the rollout replaced
    monkeypatch.setattr(tev, 'rollout', lambda *a, **kw: traj)
    _, applied = pair.t.plan_trajectory(np.zeros((len(flags[0]), 64, 64, 3),
                                                 np.float32))
    assert applied.dtype == np.int32
    np.testing.assert_array_equal(applied, want_applied)


def _proxies(n, seed=11):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 64, 64, 3) * rng.uniform(0.2, 0.9, (n, 1, 1, 1))
            ).astype(np.float32)


@pytest.mark.parametrize('which', ['pair', 'masked_pair'])
def test_plan_trajectory_matches(which, request):
    p = request.getfixturevalue(which)
    proxies = _proxies(6)
    jt, j_applied = p.j.plan_trajectory(proxies, jax.random.PRNGKey(0))
    tt, t_applied = p.t.plan_trajectory(proxies)
    np.testing.assert_array_equal(tt.filter_ids.numpy(),
                                  np.asarray(jt.filter_ids))
    np.testing.assert_array_equal(t_applied, j_applied)
    np.testing.assert_array_equal(p.t.active_mask(tt),
                                  np.asarray(p.j.active_mask(jt)))
    for field in ('pdfs', 'params', 'mask_params', 'final_image'):
        np.testing.assert_allclose(
            getattr(tt, field).numpy(), np.asarray(getattr(jt, field)),
            rtol=0, atol=1e-5, err_msg=field)


@pytest.mark.parametrize('which,shape', [('pair', (2, 96, 131, 3)),
                                         ('pair', (1, 200, 64, 3)),
                                         ('masked_pair', (2, 67, 96, 3))])
def test_retouch_matches(which, shape, request):
    p = request.getfixturevalue(which)
    rng = np.random.RandomState(shape[1])
    high = (rng.rand(*shape) * 0.8).astype(np.float32)
    proxies = np.stack([tev.downsample_to_proxy(im) for im in high])
    jt, _ = p.j.plan_trajectory(proxies, jax.random.PRNGKey(0))
    tt, _ = p.t.plan_trajectory(proxies)
    np.testing.assert_array_equal(tt.filter_ids.numpy(),
                                  np.asarray(jt.filter_ids))
    got = p.t.retouch(high, tt)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    _close_images(got, p.j.retouch(high, jt))


def test_retouch_stops_where_the_trajectory_stopped(pair):
    """A planted stop after step 2: the replay equals the chain of the
    first two steps, on both sides."""
    high = (np.random.RandomState(2).rand(2, 64, 80, 3) * 0.8).astype(
        np.float32)
    proxies = np.stack([tev.downsample_to_proxy(im) for im in high])
    tt, _ = pair.t.plan_trajectory(proxies)
    states = tt.states.clone()
    states[1:, 0, STATE_STOPPED_DIM] = 1.0      # row 0 stops after step 2
    stopped = tt._replace(states=states)
    got = pair.t.retouch(high, stopped)
    full = pair.t.retouch(high, tt)
    short = tt._replace(
        filter_ids=tt.filter_ids[:2], params=tt.params[:2],
        mask_params=tt.mask_params[:2], states=tt.states[:2])
    np.testing.assert_array_equal(got[0], pair.t.retouch(high, short)[0])
    np.testing.assert_array_equal(got[1], full[1])
    jt = JTrajectory(*(jnp.asarray(x.numpy()) for x in stopped))
    _close_images(got, pair.j.retouch(high, jt))


def test_downsample_to_proxy_is_the_antialiased_resize():
    """Equal to ``jax.image.resize(..., 'linear')`` on the centre crop
    within 1e-6, whatever the machine has installed."""
    img = np.random.RandomState(4).rand(300, 452, 3).astype(np.float32)
    got = tev.downsample_to_proxy(img, 64)
    assert got.shape == (64, 64, 3) and got.dtype == np.float32
    centre = img[:, 76:376]
    want = np.asarray(jax.image.resize(jnp.asarray(centre), (64, 64, 3),
                                       'linear'))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_load_linear_image_matches():
    np.testing.assert_array_equal(tev.load_linear_image(SAMPLE),
                                  jev.load_linear_image(SAMPLE))


def _check_debug(debug, filters):
    assert isinstance(debug, list) and len(debug) == 5
    for i, step in enumerate(debug):
        assert sorted(step) == ['all_short_names', 'applied', 'filter_id',
                                'filter_parameters', 'mask_parameters',
                                'pdf', 'short_name', 'step']
        assert type(step['step']) is int and step['step'] == i
        assert type(step['filter_id']) is int
        assert type(step['applied']) is bool
        assert type(step['short_name']) is str
        assert all(type(n) is str for n in step['all_short_names'])
        f = filters[step['filter_id']]
        for key, n in (('filter_parameters', f.get_num_filter_parameters()),
                       ('mask_parameters', f.get_num_mask_parameters()),
                       ('pdf', len(filters))):
            assert type(step[key]) is np.ndarray, key
            assert step[key].shape == (n,) and step[key].dtype == np.float32


@pytest.mark.parametrize('which,step_by_step', [('pair', True),
                                                ('pair', False),
                                                ('masked_pair', True)])
def test_eval_writes_the_same_artifact_set(which, step_by_step, request,
                                           tmp_path, monkeypatch):
    p = request.getfixturevalue(which)
    monkeypatch.setattr(jev, 'downsample_to_proxy', tev.downsample_to_proxy)
    jdir, tdir = str(tmp_path / 'j'), str(tmp_path / 't')
    jres = p.j.eval([SAMPLE], output_dir=jdir, step_by_step=step_by_step)
    tres = p.t.eval([SAMPLE], output_dir=tdir, step_by_step=step_by_step)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    base = os.path.basename(SAMPLE)
    for suffix in ARTIFACT_SET:
        assert os.path.exists(os.path.join(tdir, base + suffix)), suffix
    _close_images(tres[0]['retouched'], jres[0]['retouched'])
    assert tres[0]['file'] == SAMPLE

    # the pickles: python scalars, strings and numpy arrays only, the same
    # keys, shapes and decisions, and each package reads the other's
    name = base + '_debug.pkl'
    with open(os.path.join(tdir, name), 'rb') as f:
        raw = f.read()
    assert b'torch' not in raw
    mine = t_edit.load_debug(os.path.join(tdir, name))
    theirs = j_edit.load_debug(os.path.join(jdir, name))
    _check_debug(mine, p.t.filters)
    _check_debug(j_edit.load_debug(os.path.join(tdir, name)), p.t.filters)
    _check_debug(t_edit.load_debug(os.path.join(jdir, name)), p.t.filters)
    n_applied = sum(s['applied'] for s in mine)
    if step_by_step:
        inter = [n for n in os.listdir(tdir) if '.intermediate' in n]
        assert len(inter) == n_applied - 1
    for a, b in zip(mine, theirs):
        for key in ('step', 'filter_id', 'short_name', 'all_short_names',
                    'applied'):
            assert a[key] == b[key], key
        for key in ('filter_parameters', 'mask_parameters', 'pdf'):
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5)
    for tool, filters in ((t_edit, p.t.filters), (j_edit, p.j.filters)):
        for got, want in zip(tool.pack_trajectory(mine, filters),
                             tool.pack_trajectory(theirs, filters)):
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for tex, pkl in ((t_tex, os.path.join(jdir, name)),
                     (j_tex, os.path.join(tdir, name))):
        out = tex.convert(pkl, str(tmp_path / 'x.tex'))
        assert '\\begin{tikzpicture}' in open(out).read()

    # every image decodes at the expected size; the strip has 3 rows of
    # panels (4 with masking), one column per applied step and the input
    from exposure_tpu_torch.utils.image_io import read_png
    for n in os.listdir(tdir):
        if n.endswith('.png') and '.steps' not in n:
            assert read_png(os.path.join(tdir, n)).shape == (512, 512, 3)
    strip = read_png(os.path.join(tdir, base + '.steps.png'))
    rows = 4 if p.t.masking else 3
    assert strip.shape == (rows * 66, (n_applied + 1) * 66, 3)
    jstrip = read_png(os.path.join(jdir, base + '.steps.png'))
    assert jstrip.shape == strip.shape


def test_step_by_step_equals_the_one_launch_replay(pair, tmp_path):
    a = pair.t.eval([SAMPLE], output_dir=str(tmp_path / 'a'),
                    step_by_step=True)
    b = pair.t.eval([SAMPLE], output_dir=str(tmp_path / 'b'),
                    step_by_step=False)
    _close_images(a[0]['retouched'], b[0]['retouched'])


def _seeded_png(path, h, w, seed):
    from exposure_tpu_torch.utils.image_io import write_png
    rng = np.random.RandomState(seed)
    coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
    img = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w] * 200 + \
        rng.randint(0, 40, (h, w, 3))
    write_png(path, img.astype(np.uint8))


def test_eval_batched_groups_by_resolution_and_honours_u8(pair, tmp_path):
    files = [str(tmp_path / n) for n in ('a.png', 'b.png', 'c.png')]
    _seeded_png(files[0], 72, 100, 1)
    _seeded_png(files[1], 90, 64, 2)
    _seeded_png(files[2], 72, 100, 3)
    out = str(tmp_path / 'out')
    f32 = pair.t.eval_batched(files, output_dir=out)
    assert [r['file'] for r in f32] == [files[0], files[2], files[1]]
    assert sorted(os.listdir(out)) == sorted(
        os.path.basename(f) + s for f in files
        for s in ARTIFACT_SET[:3])
    u8 = pair.t.eval_batched(files, output_dir=str(tmp_path / 'u8'), u8=True)
    for a, b in zip(f32, u8):
        assert a['steps_applied'] == b['steps_applied']
        assert a['retouched'].shape == b['retouched'].shape
        assert b['retouched'].dtype == np.float32
        # on the u8 grid: the f32 replay of the quantized input
        grid = np.round(b['retouched'] * 255)
        np.testing.assert_allclose(grid, b['retouched'] * 255, atol=1e-3)
    # the f32 replay of the same quantized inputs against the u8 replay, on
    # one plan
    images = [tev.load_linear_image(f) for f in files]
    proxies = np.stack([tev.downsample_to_proxy(im) for im in images])
    traj, _ = pair.t.plan_trajectory(proxies)
    got = pair.t.replay_images(images, traj, u8=True)
    grid = [(np.clip(im, 0, 1) * 255.0 + 0.5).astype(np.uint8)
            .astype(np.float32) / 255.0 for im in images]
    for i, ref in enumerate(pair.t.replay_images(grid, traj)):
        assert got[i].shape == ref.shape == images[i].shape
        lsb = np.abs(np.round(np.clip(ref, 0, 1) * 255) -
                     np.round(got[i] * 255))
        assert (lsb > 1).mean() <= MAX_OUTLIER_FRAC, lsb.max()
    np.testing.assert_array_equal(got[1], u8[2]['retouched'])
    assert set(pair.t.seconds) >= {'read', 'plan', 'replay', 'write'}


def test_eval_batched_matches_jax(pair, tmp_path, monkeypatch):
    monkeypatch.setattr(jev, 'downsample_to_proxy', tev.downsample_to_proxy)
    files = [str(tmp_path / n) for n in ('a.png', 'b.png')]
    _seeded_png(files[0], 80, 120, 5)
    _seeded_png(files[1], 64, 64, 6)
    jres = pair.j.eval_batched(files, output_dir=str(tmp_path / 'j'))
    tres = pair.t.eval_batched(files, output_dir=str(tmp_path / 't'))
    for a, b in zip(tres, jres):
        assert a['file'] == b['file']
        assert a['steps_applied'] == b['steps_applied']
        _close_images(a['retouched'], b['retouched'])


def test_evaluator_defaults_and_refusals(tmp_path, monkeypatch):
    import inspect
    sig = inspect.signature(tev.Evaluator.__init__).parameters
    assert sig['device'].default == 'cuda'
    assert sig['fast_math'].default is False
    cfg = t_load_config('test')
    cfg.name = 'test/none'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tev.Evaluator(cfg)
    with pytest.raises(FileNotFoundError):
        tev.Evaluator(cfg, device='cpu')
    with pytest.raises(FileNotFoundError):
        tev.Evaluator(cfg, ckpt=100, device='cpu')
    # a run with a checkpoint (written by the JAX trainer's writer) serves
    # the checkpoint's generator, the newest or the one asked for
    from exposure_tpu.core.checkpoint import save_checkpoint
    jcfg = j_load_config('test')
    state, _ = init_train_state(jcfg, *j_build_models(jcfg)[1:], 3)
    run = str(tmp_path / 'test' / 'none')
    save_checkpoint(run, state, 20, keep=2)
    save_checkpoint(run, state.replace(gen_params=jax.tree_util.tree_map(
        lambda x: x + 1, state.gen_params)), 30, keep=2)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     state.gen_params))
    for ckpt, shift in ((None, 1), (20, 0)):
        ev = tev.Evaluator(cfg, model_root=str(tmp_path), ckpt=ckpt,
                           device='cpu')
        for k, v in ev.policy.state_dict().items():
            assert torch.equal(v, want[k] + shift), (ckpt, k)


def test_tf32_is_off_inside_the_plan_and_restored(pair, monkeypatch):
    # the plan holds the contract itself: its steps see TF32 off
    from exposure_tpu_torch.core import rollout as trollout
    seen = {}
    real = trollout.agent_step

    def spy(*a, **kw):
        seen['inside'] = (torch.backends.cudnn.allow_tf32,
                          torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **kw)

    monkeypatch.setattr(trollout, 'agent_step', spy)
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pair.t.plan_trajectory(_proxies(1))
        assert seen['inside'] == (False, False)
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def test_trained_artifact_end_to_end(tmp_path, monkeypatch):
    """The whole slice once on the trained ``synthetic_explore`` artifact:
    both packages restore it by run name, plan the three sample inputs
    (dropout off) to the same decisions and retouch them alike; the
    port's pickle reads back through both packages' tools."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(jev, 'downsample_to_proxy', tev.downsample_to_proxy)
    jcfg = j_load_config('synthetic_explore').copy()
    jcfg.dropout_keep_prob = 1.0
    jcfg.name = 'synthetic_explore/best'
    tcfg = t_load_config('synthetic_explore')
    tcfg.dropout_keep_prob = 1.0
    tcfg.name = jcfg.name
    model_root = str(tmp_path / 'models')     # no checkpoint: the artifact
    j = jev.Evaluator(jcfg, model_root=model_root)
    t = tev.Evaluator(tcfg, model_root=model_root, device='cpu')
    files = [os.path.join('docs', 'sample_inputs', 'masked%d.png' % i)
             for i in range(3)]
    images = [tev.load_linear_image(f) for f in files]
    proxies = np.stack([tev.downsample_to_proxy(im) for im in images])
    jt, j_applied = j.plan_trajectory(proxies, jax.random.PRNGKey(0))
    tt, t_applied = t.plan_trajectory(proxies)
    np.testing.assert_array_equal(tt.filter_ids.numpy(),
                                  np.asarray(jt.filter_ids))
    np.testing.assert_array_equal(t_applied, j_applied)
    np.testing.assert_allclose(tt.pdfs.numpy(), np.asarray(jt.pdfs), rtol=0,
                               atol=1e-5)
    high = np.stack(images)
    _close_images(t.retouch(high, tt), j.retouch(high, jt))
    tres = t.eval(files[:1], output_dir=str(tmp_path / 't'),
                  step_by_step=True)
    _close_images(tres[0]['retouched'], t.retouch(high[:1], tt._replace(
        filter_ids=tt.filter_ids[:, :1], params=tt.params[:, :1],
        mask_params=tt.mask_params[:, :1], states=tt.states[:, :1]))[0])
    pkl = str(tmp_path / 't' / 'masked0.png_debug.pkl')
    for tool, filters in ((t_edit, t.filters), (j_edit, j.filters)):
        ids, params, masks, active = tool.pack_trajectory(
            tool.load_debug(pkl), filters)
        np.testing.assert_array_equal(ids[:, 0], tt.filter_ids[:, 0].numpy())
        np.testing.assert_array_equal(active[:, 0], t.active_mask(tt)[:, 0])
