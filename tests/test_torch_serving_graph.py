"""Serving as one program a batch (``core/serving_graph.py``) on the CPU,
where a ``BatchGraph`` runs its static-buffer body eagerly (the card
captures and replays the same body):

- ``graphs=True`` equals the per-call path bit for bit in every
  non-grouped mode, u8 and f32, dropout on, and in the grouped mode, whose
  plan is the graph;
- that body equals the JAX ``RetouchPipeline._single_jit`` with the Pallas
  kernels in interpret mode on the rows whose plans agree (dropout off on
  both sides: the random streams differ), with the tolerances of
  tests/test_torch_serving.py::test_pipeline_matches_jax;
- a graph's generator, reseeded for (seed, i), draws what
  ``batch_generator(seed, i)`` draws, and one that takes a generator's
  state leaves it where the eager draws leave it;
- ``map_batches(device_out=True)`` hands out outputs that the next batch
  does not overwrite; ``warmup`` captures once; ``release`` frees; the
  cache keeps at most ``MAX_GRAPHS``;
- the kernel accounting: executions are the kernels' launches
  (``kernels.launch_counts``) less those captures recorded plus those
  replays ran;
- the served plan's convolutions run in the layout of its dtype;
- the evaluator's graph-form plan equals its per-call plan;
- ``load_policy`` copies the weights into the served tensors in place, the
  bf16 copy rounded as a fresh ``.to(torch.bfloat16)``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exposure_tpu_torch.core.serving_graph as sg
from exposure_tpu.core.serving import RetouchPipeline as JPipeline
from exposure_tpu_torch.core.evaluator import Evaluator
from exposure_tpu_torch.core.serving import (
    MAX_GRAPHS,
    RetouchPipeline,
    batch_generator,
    batch_seed,
)
from exposure_tpu_torch.models.networks import build_policy, init_like_flax
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.utils.config import load_config

MODES = {
    'dynamic_selected_plan': dict(dynamic=True, selected_plan=True),
    'dynamic_bank_plan': dict(dynamic=True, selected_plan=False),
    'switch': dict(dynamic=False, grouped=False),
}


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its bodies are thousands
    of small ops, which the thread pool's spin-waits slow a hundredfold when
    the suite's workers share the cores (measured: 0.9 s alone, 467 s in six
    processes at once, 6 s with one thread each)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _policy(cfg, seed):
    return init_like_flax(build_policy(cfg, build_filters(cfg)),
                          torch.Generator().manual_seed(seed)).eval()


def _pipe(cfg, policy, graphs, **kw):
    return RetouchPipeline(cfg, policy, device='cpu', use_kernels=True,
                           graphs=graphs, **kw)


def _images(seed, dtype, b=4, h=32, w=48):
    x = np.random.RandomState(seed).rand(b, h, w, 3)
    return (x * 255).astype(np.uint8) if dtype == 'uint8' \
        else x.astype(np.float32)


@pytest.fixture(scope='module')
def served():
    """The ``test`` config with dropout on (keep 0.5) and a seeded
    policy."""
    cfg = load_config('test')
    return cfg, _policy(cfg, 3)


@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
@pytest.mark.parametrize('mode', sorted(MODES))
def test_graph_body_is_the_per_call_path(served, mode, dtype):
    cfg, policy = served
    graph = _pipe(cfg, policy, True, **MODES[mode])
    eager = _pipe(cfg, policy, False, **MODES[mode])
    batches = [_images(10 + i, dtype) for i in range(3)]
    got = list(graph.map_batches(batches, seed=7))
    want = list(eager.map_batches(batches, seed=7))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == batches[0].dtype
        np.testing.assert_array_equal(a, b)
    # a batch's output is a function of its images, the seed and its index
    np.testing.assert_array_equal(graph(batches[1], 7, 1), want[1])
    rep = graph.graph_report()
    assert (rep['graphs'], rep['captures'], rep['replays']) == (1, 1, 4)
    assert eager.graph_report()['graphs'] == 0


def test_grouped_plan_graph_is_the_per_call_plan(served):
    cfg, policy = served
    graph = _pipe(cfg, policy, True, grouped=True, fused_set_limit=0)
    eager = _pipe(cfg, policy, False, grouped=True, fused_set_limit=0)
    batches = [_images(20 + i, 'uint8', b=8) for i in range(3)]
    for i, img in enumerate(batches):
        x = torch.from_numpy(img)
        for a, b in zip(graph._plan_batch(x, 4, i),
                        eager._plan_batch(x, 4, i)):
            assert torch.equal(a, b)
    got = list(graph.map_batches(batches, seed=4, depth=1))
    want = list(eager.map_batches(batches, seed=4, depth=1))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert graph.graph_report()['captures'] == 1


@pytest.fixture(scope='module')
def parity():
    """A random-init ``test`` policy on both sides, dropout keep 1.0."""
    from exposure_tpu.models.networks import PolicyNet as JPolicyNet
    from exposure_tpu.utils import load_config as j_load_config
    from exposure_tpu_torch.core.artifacts import flax_to_state_dict
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
    tcfg = load_config('test')
    tcfg.dropout_keep_prob = 1.0
    policy = build_policy(tcfg, build_filters(tcfg))
    policy.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, gen_params)))
    import types
    return jcfg, types.SimpleNamespace(gen_params=gen_params), tcfg, \
        policy.eval()


@pytest.mark.parametrize('mode, dtype', [
    ('dynamic_selected_plan', 'uint8'), ('dynamic_selected_plan', 'float32'),
    ('dynamic_bank_plan', 'uint8'), ('switch', 'uint8')])
def test_graph_body_matches_the_jax_single_jit(parity, mode, dtype):
    jcfg, state, tcfg, policy = parity
    imgs = _images(2, dtype, h=64, w=128)
    jpipe = JPipeline(jcfg, state, use_pallas=True, interpret=True,
                      **MODES[mode])
    want = np.asarray(jpipe._single_jit(jnp.asarray(imgs),
                                        jax.random.PRNGKey(3)))
    tpipe = _pipe(tcfg, policy, True, **MODES[mode])
    got = tpipe(imgs, seed=3)
    assert got.dtype == imgs.dtype and got.shape == imgs.shape
    # the rows whose plans agree: the JAX plan of the JAX program's proxy
    src = jnp.asarray(imgs).astype(jnp.float32)
    if dtype == 'uint8':
        src = src * (1.0 / 255.0)
    proxy = jax.image.resize(src, (4, 64, 64, 3), method='linear')
    if tpipe.selected_plan:
        from exposure_tpu.core.rollout import serve_rollout
        j_ids = serve_rollout(jpipe.policy, state.gen_params, proxy,
                              jax.random.PRNGKey(0), cfg=jcfg,
                              filters=jpipe.filters, fast_math=True,
                              interpret=True)[0]
    else:
        j_ids = jpipe._plan_for(jnp.asarray(imgs), jax.random.PRNGKey(0))[0]
    with torch.no_grad():
        t_ids = tpipe.plan(tpipe.proxy(torch.from_numpy(imgs)), None)[0]
    same = (t_ids.numpy() == np.asarray(j_ids)).all(axis=0)
    assert same.sum() >= 2, 'plans agree on %d of 4 rows' % same.sum()
    if dtype == 'uint8':
        lsb = np.abs(got[same].astype(np.int32) -
                     want[same].astype(np.int32))
        assert lsb.max() <= 1, 'off by %d LSB' % lsb.max()
    else:
        np.testing.assert_allclose(got[same], want[same], atol=3e-5,
                                   rtol=1e-4)


def _draws(x, g):
    return torch.rand(x.shape, generator=g), \
        torch.randint(0, 1000, (7,), generator=g)


def test_a_reseeded_graph_draws_the_batch_generators_draws():
    x = torch.zeros(5, 3)
    graph = sg.BatchGraph(_draws, x, 'cpu')
    for seed, index in ((0, 0), (9, 2), (0, 0), (9, 3)):
        got = [t.clone() for t in graph.run(x, batch_seed(seed, index))]
        want = _draws(x, batch_generator(seed, index, 'cpu'))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # a generator's state in, and back out where the draws leave it
    src, ref = batch_generator(4, 1, 'cpu'), batch_generator(4, 1, 'cpu')
    got = [t.clone() for t in graph.run(x, src)]
    for a, b in zip(got, _draws(x, ref)):
        assert torch.equal(a, b)
    assert torch.equal(src.get_state(), ref.get_state())
    assert graph.captures == 1 and graph.replays == 5


def test_device_out_outputs_are_not_overwritten(served):
    cfg, policy = served
    pipe = _pipe(cfg, policy, True)
    batches = [_images(30 + i, 'uint8') for i in range(3)]
    outs = list(pipe.map_batches(batches, seed=2, device_out=True))
    assert len({id(o) for o in outs}) == 3
    static = list(pipe._graphs.graphs.values())[0].outputs
    assert all(o is not static for o in outs)
    for i, (o, b) in enumerate(zip(outs, batches)):
        np.testing.assert_array_equal(o.numpy(), pipe(b, 2, i))
    assert not np.array_equal(outs[0].numpy(), outs[1].numpy())
    # the host arrays are copies too
    first = pipe(batches[0], 2, 0)
    pipe(batches[1], 2, 1)
    np.testing.assert_array_equal(first, outs[0].numpy())


@pytest.mark.parametrize('mode', ['dynamic_selected_plan', 'switch'])
def test_warmup_captures_the_batch_graph_once(served, mode):
    cfg, policy = served
    pipe = _pipe(cfg, policy, True, **MODES[mode])
    imgs = _images(40, 'uint8')
    rep = pipe.warmup(imgs)
    assert rep['programs_compiled'] == 1 and rep['captures'] == 1
    assert rep['capture_seconds'] == 0.0      # nothing to capture here
    again = pipe.warmup(imgs)
    assert again['programs_compiled'] == 0 and again['captures'] == 0
    assert pipe.graph_report()['captures'] == 1
    # per call the warm-up reports the one route, as JAX does
    eager = _pipe(cfg, policy, False, **MODES[mode]).warmup(imgs)
    assert eager['programs_compiled'] == 1 and eager['captures'] == 0


def test_release_and_the_cache_limit(served):
    cfg, policy = served
    pipe = _pipe(cfg, policy, True)
    shapes = [(2, 16 + 8 * i, 24, 3) for i in range(MAX_GRAPHS + 1)]
    first = None
    for i, shape in enumerate(shapes):
        pipe(np.zeros(shape, np.uint8), 0, i)
        if first is None:
            first = list(pipe._graphs.graphs.values())[0]
    assert pipe.graph_report()['graphs'] == MAX_GRAPHS
    assert first.input is None and first.outputs is None   # released
    kept = list(pipe._graphs.graphs.values())
    pipe.release()
    assert pipe.graph_report()['graphs'] == 0
    assert all(g.input is None and g.outputs is None for g in kept)
    pipe(np.zeros(shapes[0], np.uint8))
    assert pipe.graph_report()['captures'] == 1


def test_executions_count_recorded_and_replayed_launches(monkeypatch):
    """A capture that records 6 K1 launches (``kernels.launch`` counts
    them, the capture runs nothing), then 3 replays: 18 executions; after
    the counts are set to 0, the replays alone count, under keys that no
    launch has counted since."""
    monkeypatch.setattr(sg, 'RECORDED', sg.collections.Counter())
    monkeypatch.setattr(sg, 'REPLAYED', sg.collections.Counter())
    sg.RECORDED.update({'dyn_chain': 6})
    for _ in range(3):
        sg.REPLAYED.update({'dyn_chain': 6})
    assert sg.executions({'dyn_chain': 6 + 6, 'switch_chain': 2}) == \
        {'dyn_chain': 6 + 18, 'switch_chain': 2}
    sg.reset_counts()
    assert not sg.RECORDED and not sg.REPLAYED
    sg.REPLAYED.update({'dyn_chain': 6, 'proxy_resize': 1})
    counts = sg.executions(sg.collections.Counter())
    assert counts == {'dyn_chain': 6, 'proxy_resize': 1}
    assert counts['switch_chain'] == 0


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_extractor_layout_counts_a_served_batch(served, bf16):
    """The selected plan's extractor forwards, two a step, reach every
    convolution in the layout their dtype chooses (a forward pre-hook on
    each): NCHW in float32, channels-last in the bf16 plan."""
    cfg, policy = served
    pipe = _pipe(cfg, copy.deepcopy(policy), True, bf16=bf16)
    batches = [_images(50 + i, 'uint8') for i in range(2)]
    extractors = (pipe._plan_policy.shared_extractor,
                  pipe._plan_policy.selector_extractor)
    layouts = sg.collections.Counter()

    def seen(module, args):
        x = args[0]
        layouts[x.dtype, 'nchw' if x.is_contiguous() else 'channels_last'
                if x.is_contiguous(memory_format=torch.channels_last)
                else 'other'] += 1
    for fx in extractors:
        for conv in fx.convs:
            conv.register_forward_pre_hook(seen)
    list(pipe.map_batches(batches, seed=3))
    convs = sum(len(fx.convs) for fx in extractors)
    want = (torch.bfloat16, 'channels_last') if bf16 else \
        (torch.float32, 'nchw')
    assert layouts == {want: convs * cfg.test_steps * len(batches)}


def test_evaluator_plan_graph_is_the_per_call_plan(served):
    cfg, policy = served
    proxies = np.random.RandomState(5).rand(3, 64, 64, 3).astype(np.float32)
    evs = {g: Evaluator(cfg, policy=copy.deepcopy(policy), device='cpu',
                        graphs=g) for g in (True, False)}
    trajs = {}
    for g, ev in evs.items():
        gen = batch_generator(6, 0, 'cpu')
        trajs[g] = [ev.plan_trajectory(proxies, gen) for _ in range(2)]
        trajs[g].append(gen.get_state())
    for (ta, aa), (tb, ab) in zip(trajs[True][:2], trajs[False][:2]):
        for a, b in zip(ta, tb):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(aa, ab)
    # the caller's generator advanced alike, so the two plans differ
    assert torch.equal(trajs[True][2], trajs[False][2])
    assert not torch.equal(trajs[True][0][0].filter_ids,
                           trajs[True][1][0].filter_ids) or not torch.equal(
        trajs[True][0][0].params, trajs[True][1][0].params)
    assert evs[True]._graphs.report()['captures'] == 1


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_load_policy_swaps_in_place(bf16):
    cfg = load_config('test')
    a, b = _policy(cfg, 1), _policy(cfg, 2)
    pipe = _pipe(cfg, copy.deepcopy(a), True, bf16=bf16)
    imgs = _images(50, 'uint8')
    before = pipe(imgs, 1, 0)
    tensors = {name: (t, t.data_ptr()) for name, t in
               list(pipe.policy.state_dict().items()) +
               [('bf16.' + n, t) for n, t in
                pipe._plan_policy.state_dict().items()]}
    pipe.load_policy(b.state_dict(), run='b', step=3)
    assert (pipe.run, pipe.step) == ('b', 3)
    f32, b16 = pipe.policy.state_dict(), pipe._plan_policy.state_dict()
    for name, (t, ptr) in tensors.items():
        now = b16[name[5:]] if name.startswith('bf16.') else f32[name]
        assert now is t or now.data_ptr() == ptr, name
    want = b.state_dict()
    for name, t in f32.items():
        assert torch.equal(t, want[name])
    for name, t in b16.items():
        expect = want[name].to(torch.bfloat16) if bf16 else want[name]
        assert t.dtype == expect.dtype and torch.equal(t, expect)
    fresh = _pipe(cfg, copy.deepcopy(b), False, bf16=bf16)
    got = pipe(imgs, 1, 0)
    np.testing.assert_array_equal(got, fresh(imgs, 1, 0))
    assert not np.array_equal(got, before)
    assert pipe.graph_report()['captures'] == 1
