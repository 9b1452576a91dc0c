"""The serving slice of the port against the JAX package:

- the port's config table equals ``exposure_tpu.utils.load_config`` on
  every knob serving reads;
- the agent helpers match their JAX counterparts;
- ``serve_rollout`` matches JAX: step-0 ids identical, params within 1e-5
  while the trajectories agree, and later id flips only at near-tie
  margins (the rule of tests/test_serve_rollout.py);
- the end-to-end output of ``RetouchPipeline`` matches the JAX pipeline
  on rows whose plans agree: u8 within 1 LSB, f32 within atol 3e-5 /
  rtol 1e-4;
- the port imports with ``jax`` and ``flax`` refused.

Dropout keep is 1.0 on both sides wherever outputs are compared: JAX and
torch draw different random bits."""

import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from exposure_tpu.core.rollout import serve_rollout as j_serve_rollout
from exposure_tpu.core.serving import RetouchPipeline as JPipeline
from exposure_tpu.models import agent as jagent
from exposure_tpu.models.networks import PolicyNet as JPolicyNet
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.core.artifacts import flax_to_state_dict
from exposure_tpu_torch.core.rollout import serve_rollout as t_serve_rollout
from exposure_tpu_torch.core.serving import RetouchPipeline as TPipeline
from exposure_tpu_torch.models import agent as tagent
from exposure_tpu_torch.models.networks import build_policy
from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.utils.config import CONFIGS
from exposure_tpu_torch.utils.config import load_config as t_load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# knobs the JAX agent_step reads with cfg.get and these defaults
# (exposure_tpu/models/agent.py:177-249)
AGENT_STEP_DEFAULTS = {
    'replay_inject_prob': 0.0, 'replay_inject_until': 1.0,
    'replay_inject_mode': 'uniform', 'entropy_respike': 0.0,
    'entropy_respike_center': 0.5, 'entropy_respike_width': 0.15,
    # and the JAX trainer reads these so (exposure_tpu/core/trainer.py)
    'critic_burst': 100, 'warmup_giters': 100, 'checkpoint_interval': 500,
    'seed': 0, 'iters_per_dispatch': 1, 'dispatch_pipeline_depth': 2}


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_config_table_matches_load_config(name):
    jcfg, tcfg = j_load_config(name), t_load_config(name)
    assert list(tcfg.filters) == [c.__name__ for c in jcfg.filters]
    # every knob of the JAX config is in the row
    missing = sorted(set(jcfg) - set(tcfg))
    assert not missing, missing
    for knob in ('exploration_penalty', 'filter_usage_penalty',
                 'early_stop_penalty', 'gan', 'use_TD', 'giters', 'citers',
                 'lr_g', 'lr_c', *AGENT_STEP_DEFAULTS):
        assert knob in tcfg, knob
    for knob, value in tcfg.items():
        if knob in ('filters', 'name'):
            continue
        if knob in ('lr_g', 'lr_c'):
            # the learning-rate schedules, at iterations across the run
            for t in (0, 1, 7, jcfg.max_iter_step // 3, jcfg.max_iter_step):
                assert value(t) == jcfg[knob](t), (knob, t)
            continue
        if callable(value):
            # a data provider factory: tests/test_torch_eval_tools.py and
            # tests/test_torch_data_paths.py hold what it builds equal to
            # the JAX config's
            assert knob.endswith('_data_provider') or \
                knob.endswith('_data_provider_test')
            assert callable(jcfg[knob])
            continue
        want = jcfg.get(knob, AGENT_STEP_DEFAULTS.get(knob, KeyError))
        assert want == value, knob
    if name == 'synthetic_explore':
        assert tcfg.exploration_penalty == 0.2


def test_agent_helpers_match_jax(rng):
    cfg = t_load_config('masked')
    jcfg = j_load_config('masked')
    tf = build_filters(cfg)
    jf = [f(jcfg) for f in jcfg.filters]
    b, n = 5, len(tf)
    img = rng.rand(b, 8, 8, 3).astype(np.float32)
    st = rng.rand(b, cfg.num_state_dim).astype(np.float32)
    np.testing.assert_array_equal(
        tagent.enrich_image_input(cfg, torch.from_numpy(img),
                                  torch.from_numpy(st)).numpy(),
        np.asarray(jagent.enrich_image_input(jcfg, jnp.asarray(img),
                                             jnp.asarray(st))))
    params = [rng.randn(b, f.get_num_filter_parameters()).astype(np.float32)
              for f in jf]
    masks = [rng.randn(b, f.get_num_mask_parameters()).astype(np.float32)
             for f in jf]
    masks[1] = None
    got = tagent.pack_param_rows(
        tf, [torch.from_numpy(p) for p in params],
        [None if m is None else torch.from_numpy(m) for m in masks], b,
        torch.float32)
    want = jagent.pack_param_rows(
        jf, [jnp.asarray(p) for p in params],
        [None if m is None else jnp.asarray(m) for m in masks], b,
        jnp.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # exact ties: both frameworks pick the first maximum
    logits = rng.randn(b, n).astype(np.float32)
    logits[0, :] = 0.0
    logits[1, 2] = logits[1, 5] = 9.0
    pdf_t = tagent.action_distribution(torch.from_numpy(logits), cfg, n)
    pdf_j = jagent.action_distribution(jnp.asarray(logits), jcfg, n)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(torch.argmax(pdf_t, dim=1).numpy(),
                                  np.asarray(jnp.argmax(pdf_j, axis=1)))
    assert torch.argmax(pdf_t, dim=1)[0] == 0
    ids = rng.randint(0, n, b)
    st[:, 2] = rng.randint(0, 5, b)
    oh = np.eye(n, dtype=np.float32)[ids]
    for g, w in zip(
            tagent.advance_states(torch.from_numpy(st), torch.from_numpy(oh),
                                  cfg, torch.float32),
            jagent.advance_states(jnp.asarray(st), jnp.asarray(oh), jcfg,
                                  jnp.float32)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert torch.equal(tagent.initial_states(3, 11),
                       torch.zeros(3, 11))


@pytest.fixture(scope='module')
def models():
    """A random-init ``test`` policy on both sides, dropout keep 1.0."""
    jcfg = j_load_config('test').copy()
    jcfg.dropout_keep_prob = 1.0
    jfilters = [f(jcfg) for f in jcfg.filters]
    jpolicy = JPolicyNet(
        filter_output_dims=tuple(
            f.get_num_filter_parameters() + f.get_num_mask_parameters()
            for f in jfilters),
        feature_extractor_dims=jcfg.feature_extractor_dims,
        base_channels=jcfg.base_channels, fc1_size=jcfg.fc1_size,
        dropout_keep_prob=1.0)
    key = jax.random.PRNGKey(0)
    gen_params = jpolicy.init({'params': key, 'dropout': key},
                              jnp.zeros((2, 64, 64, 3 + jcfg.num_state_dim)))
    tcfg = t_load_config('test')
    tcfg.dropout_keep_prob = 1.0
    tfilters = build_filters(tcfg)
    policy = build_policy(tcfg, tfilters)
    policy.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, gen_params)))
    return types.SimpleNamespace(
        jcfg=jcfg, jfilters=jfilters, jpolicy=jpolicy, gen_params=gen_params,
        tcfg=tcfg, tfilters=tfilters, policy=policy.eval())


def _j_plan(m, proxy):
    ids, params, _ = j_serve_rollout(
        m.jpolicy, m.gen_params, jnp.asarray(proxy), jax.random.PRNGKey(0),
        cfg=m.jcfg, filters=m.jfilters, interpret=True, fast_math=True)
    return np.array(ids), np.array(params)


def _margins_along(m, proxy, ids, params):
    """Top-2 pdf margins of the port's policy at each step of a given
    trajectory."""
    img = torch.from_numpy(proxy)
    st = tagent.initial_states(img.shape[0], m.tcfg.num_state_dim)
    out = []
    with torch.no_grad():
        for k in range(ids.shape[0]):
            _, logits = m.policy(tagent.enrich_image_input(m.tcfg, img, st))
            pdf = tagent.action_distribution(logits, m.tcfg,
                                             len(m.tfilters))
            top2 = torch.sort(pdf, dim=1).values[:, -2:]
            out.append((top2[:, 1] - top2[:, 0]).numpy())
            step_ids = torch.from_numpy(ids[k])
            img = apply_filter_chain_dynamic(
                img, step_ids[None], torch.from_numpy(params[k])[None],
                m.tfilters, fast_math=True)
            oh = F.one_hot(step_ids.long(), len(m.tfilters)).float()
            st, _, _ = tagent.advance_states(st, oh, m.tcfg, torch.float32)
    return np.stack(out)


def test_serve_rollout_matches_jax(models):
    m = models
    proxy = np.random.RandomState(1).rand(8, 64, 64, 3).astype(np.float32)
    ref_ids, ref_params = _j_plan(m, proxy)
    with torch.no_grad():
        ids, params, mask = t_serve_rollout(
            m.policy, torch.from_numpy(proxy), None, cfg=m.tcfg,
            filters=m.tfilters)
    ids, params = ids.numpy(), params.numpy()
    assert ids.dtype == np.int32 and ids.shape == ref_ids.shape
    assert params.shape == ref_params.shape and mask.shape == (5, 8, 6)
    np.testing.assert_array_equal(ids[0], ref_ids[0])
    margins = _margins_along(m, proxy, ref_ids, ref_params)
    diverged = np.zeros(ids.shape[1], bool)
    for k in range(ids.shape[0]):
        flip = ids[k] != ref_ids[k]
        fresh_confident_flip = flip & ~diverged & (margins[k] > 1e-3)
        assert not fresh_confident_flip.any(), (
            'flipped a confident action at step %d (margins %r)'
            % (k, margins[k][flip & ~diverged]))
        diverged |= flip
    live = ~diverged
    assert live.any(), 'every record diverged: plan parity is broken'
    np.testing.assert_allclose(params[:, live], ref_params[:, live],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
def test_pipeline_matches_jax(models, dtype):
    m = models
    x = np.random.RandomState(2).rand(4, 64, 128, 3)
    imgs = (x * 255).astype(np.uint8) if dtype == 'uint8' \
        else x.astype(np.float32)
    jpipe = JPipeline(m.jcfg, types.SimpleNamespace(gen_params=m.gen_params),
                      use_pallas=True, interpret=True, dynamic=True,
                      selected_plan=True)
    want = np.asarray(jpipe(imgs, seed=3))
    tpipe = TPipeline(m.tcfg, m.policy, use_kernels=True, device='cpu')
    assert tpipe.dynamic and tpipe.selected_plan
    got = tpipe(imgs, seed=3)
    assert got.dtype == imgs.dtype
    assert got.shape == imgs.shape
    # which rows planned the same trajectory on both sides
    src = jnp.asarray(imgs).astype(jnp.float32)
    if dtype == 'uint8':
        src = src * (1.0 / 255.0)
    j_proxy = jax.image.resize(src, (4, 64, 64, 3), method='linear')
    j_ids, _ = _j_plan(m, np.asarray(j_proxy))
    with torch.no_grad():
        t_ids = tpipe.plan(tpipe.proxy(torch.from_numpy(imgs)), None)[0]
    same = (t_ids.numpy() == j_ids).all(axis=0)
    assert same.sum() >= 2, 'plans agree on %d of 4 rows' % same.sum()
    if dtype == 'uint8':
        lsb = np.abs(got[same].astype(np.int32) -
                     want[same].astype(np.int32))
        assert lsb.max() <= 1, 'end-to-end u8 off by %d LSB' % lsb.max()
    else:
        np.testing.assert_allclose(got[same], want[same], atol=3e-5,
                                   rtol=1e-4)


def test_map_batches_is_the_per_batch_call():
    cfg = t_load_config('test')   # dropout on: keep 0.5
    torch.manual_seed(0)
    pipe = TPipeline(cfg, build_policy(cfg, build_filters(cfg)), device='cpu')
    rng = np.random.RandomState(4)
    batches = [(rng.rand(2, 64, 64, 3) * 255).astype(np.uint8)
               for _ in range(2)]
    outs = list(pipe.map_batches(batches, seed=5))
    assert len(outs) == 2
    for i, (b, o) in enumerate(zip(batches, outs)):
        assert o.dtype == np.uint8 and o.shape == b.shape
        assert np.array_equal(o, pipe(b, 5, i))
    assert np.array_equal(outs[0], pipe(batches[0], seed=5))


@pytest.mark.parametrize('mode', ['dynamic', 'grouped'])
def test_device_out_chooses_the_return_type(mode):
    """``__call__`` and ``map_batches`` return host arrays, as the JAX
    pipeline does (exposure_tpu/core/serving.py:550-565), and tensors on
    the pipeline's device with ``device_out=True``; both hold the same
    values."""
    import inspect
    for fn in (TPipeline.__call__, TPipeline.map_batches, JPipeline.__call__,
               JPipeline.map_batches):
        assert inspect.signature(fn).parameters['device_out'].default \
            is False
    cfg = t_load_config('test')
    torch.manual_seed(0)
    pipe = TPipeline(cfg, build_policy(cfg, build_filters(cfg)),
                     use_kernels=True, grouped=(mode == 'grouped'),
                     device='cpu')
    imgs = (np.random.RandomState(6).rand(2, 64, 64, 3) * 255).astype(
        np.uint8)
    host = pipe(imgs, seed=2)
    dev = pipe(imgs, seed=2, device_out=True)
    assert isinstance(host, np.ndarray) and host.dtype == np.uint8
    assert torch.is_tensor(dev) and dev.device == pipe.device
    np.testing.assert_array_equal(host, dev.numpy())
    streamed = list(pipe.map_batches([imgs, imgs], seed=2))
    on_dev = list(pipe.map_batches([imgs, imgs], seed=2, device_out=True))
    assert all(isinstance(o, np.ndarray) for o in streamed)
    assert all(torch.is_tensor(o) for o in on_dev)
    for a, b in zip(streamed, on_dev):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(streamed[0], host)


def test_serve_rollout_num_steps_matches_jax(models):
    """``num_steps`` defaults to ``cfg.test_steps`` on both sides; K=3
    gives the first three steps of the JAX plan: ids equal at step 0 and
    wherever the trajectories agree, params within 1e-5 there."""
    import inspect
    m = models
    assert inspect.signature(t_serve_rollout).parameters[
        'num_steps'].default is None
    proxy = np.random.RandomState(5).rand(6, 64, 64, 3).astype(np.float32)
    ref_ids, ref_params, _ = j_serve_rollout(
        m.jpolicy, m.gen_params, jnp.asarray(proxy), jax.random.PRNGKey(0),
        cfg=m.jcfg, filters=m.jfilters, num_steps=3, interpret=True,
        fast_math=True)
    ref_ids, ref_params = np.array(ref_ids), np.array(ref_params)
    with torch.no_grad():
        ids, params, mask = t_serve_rollout(
            m.policy, torch.from_numpy(proxy), None, cfg=m.tcfg,
            filters=m.tfilters, num_steps=3)
        full = t_serve_rollout(m.policy, torch.from_numpy(proxy), None,
                               cfg=m.tcfg, filters=m.tfilters)
    assert ids.shape == ref_ids.shape == (3, 6)
    assert params.shape == ref_params.shape and mask.shape[:2] == (3, 6)
    assert full[0].shape == (m.tcfg.test_steps, 6)
    assert torch.equal(full[0][:3], ids)
    np.testing.assert_array_equal(ids[0].numpy(), ref_ids[0])
    live = (ids.numpy() == ref_ids).all(axis=0)
    assert live.sum() >= 3, 'plans agree on %d of 6 rows' % live.sum()
    np.testing.assert_allclose(params.numpy()[:, live], ref_params[:, live],
                               rtol=0, atol=1e-5)


def test_pipeline_defaults_to_the_card(monkeypatch):
    """Serving runs on the card unless the caller asks for the CPU: every
    entry point defaults to 'cuda', and without a GPU a pipeline built
    with the default raises instead of serving on the host."""
    import inspect
    from exposure_tpu_torch.ops.grouped_chain import GroupedChainRunner
    for fn in (TPipeline.__init__, TPipeline.from_artifact,
               GroupedChainRunner.warmup, GroupedChainRunner.warmup_superset):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    cfg = t_load_config('test')
    policy = build_policy(cfg, build_filters(cfg))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TPipeline(cfg, policy)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TPipeline.from_artifact('synthetic_explore', os.path.join(
            REPO, 'artifacts', 'serving',
            'synthetic_explore--best.msgpack.gz'))
    assert next(policy.parameters()).device.type == 'cpu'
    pipe = TPipeline(cfg, policy, device='cpu')
    assert pipe.device.type == 'cpu' and not pipe.use_kernels


def test_port_imports_without_jax_or_flax():
    code = textwrap.dedent('''
        import sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                          'exposure_tpu'):
                    raise ImportError('refused: ' + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import importlib
        import pkgutil

        import exposure_tpu_torch

        def unimportable(name):
            raise ImportError('cannot import ' + name)

        walked = [m.name for m in pkgutil.walk_packages(
            exposure_tpu_torch.__path__, 'exposure_tpu_torch.',
            onerror=unimportable)]
        for name in walked:
            importlib.import_module(name)
        # every module of the package, the seven last tools among them
        for name in ('tools.bench_truth', 'tools.branch_roofline',
                     'tools.bench_upload', 'tools.bench_dispatch',
                     'tools.import_reference_data', 'tools.fetch_fivek_test',
                     'tools.fetch_fivek', 'tools.user_study.main',
                     'core.serving_graph', 'kernels', 'native.build'):
            assert 'exposure_tpu_torch.' + name in walked, name
        from exposure_tpu_torch.utils.config import CONFIGS, load_config
        for name in CONFIGS:
            load_config(name)
        import glob
        roots = sorted(glob.glob('*_torch.py')) + ['chip_smoke.py']
        assert {'bench_torch.py', 'bench_stream_torch.py',
                'bench_train_torch.py', 'evaluate_torch.py',
                'train_torch.py'} <= set(roots), roots
        for path in roots:
            importlib.import_module(path[:-3])
        bad = [m for m in sys.modules
               if m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                      'exposure_tpu')]
        assert not bad, bad
        print('ok')
    ''')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == 'ok', \
        proc.stderr[-2000:]
