"""The program's own tracing (``exposure_tpu_torch/utils/trace.py``):

- off (the default): ``span`` and ``region`` return one shared no-op
  context, a region leaves no stamp, and nothing is built;
- on, on the CPU: a pipeline batch stamps ``serve.resize``,
  ``serve.plan`` and ``serve.replay`` in that order, and its host ranges
  reach the profiler; a fused ``(1, 5)`` chunk of two iterations stamps 2
  generator, 2 critic and 12 Adam regions, each Adam region inside its
  phase; a full ring counts the stamps it drops and keeps the first;
- ``tools.profile_calls``' device numbers: the union of the device's
  intervals, without the host ranges the profiler mirrors onto the
  device's timeline;
- on the card (``-m cuda``): a batch graph captured with tracing on
  stamps 6 times a replay, its regions summing to the CUDA events around
  the replays; one captured with tracing off holds no stamp kernel."""

import types

import pytest
import torch

from exposure_tpu_torch import kernels
from exposure_tpu_torch.core.replay import PoolState
from exposure_tpu_torch.core.serving import RetouchPipeline
from exposure_tpu_torch.core.steps import build_fused_iterations_step
from exposure_tpu_torch.core.train_state import init_train_state
from exposure_tpu_torch.models.networks import build_models, build_policy, \
    init_like_flax
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.tools import device_work, union_us
from exposure_tpu_torch.utils import trace
from exposure_tpu_torch.utils.config import load_config
from exposure_tpu_torch.utils.draws import Draws

SERVE_REGIONS = ('serve.resize', 'serve.plan', 'serve.replay')


@pytest.fixture
def traced():
    was = trace.enable(True)
    trace.reset()
    yield
    trace.enable(was)
    trace.reset()


@pytest.fixture
def untraced():
    was = trace.enable(False)
    trace.reset()
    yield
    trace.enable(was)
    trace.reset()


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _pipe(device='cpu', graphs=True):
    cfg = load_config('test')
    policy = init_like_flax(build_policy(cfg, build_filters(cfg)),
                            torch.Generator().manual_seed(3)).eval()
    return RetouchPipeline(cfg, policy, device=device, use_kernels=True,
                           graphs=graphs)


def _images(b, h, w, device='cpu', seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                         generator=g).to(device)


def _pairs(stamps):
    """``[(name, enter ns, exit ns, depth)]`` of stamps that nest."""
    out, stack = [], []
    for name, kind, ns in stamps:
        if kind == 'enter':
            stack.append((name, ns))
        else:
            opened, t0 = stack.pop()
            assert opened == name, (opened, name)
            out.append((name, t0, ns, len(stack)))
    assert not stack
    return out


def test_off_is_one_shared_no_op_and_builds_nothing(untraced, monkeypatch):
    def no_build(*a, **k):
        raise AssertionError('tracing off built a library')
    monkeypatch.setattr(kernels, 'build', no_build)
    assert not trace.enabled()
    assert trace.span('serve.call') is trace.region('serve.plan', 'cuda') \
        is trace.region('train.adam', 'cpu')
    with trace.region('serve.plan', 'cuda'), trace.span('fused.run'):
        pass
    pipe = _pipe()
    pipe(_images(2, 24, 32), seed=1, index=0, device_out=True)
    assert trace.stamps() == [] and trace.dropped() == 0


@pytest.mark.parametrize('graphs', [True, False])
def test_pipeline_batch_stamps_resize_plan_replay(traced, graphs):
    pipe = _pipe(graphs=graphs)
    images = _images(2, 24, 32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe(images, seed=1, index=0)
    stamps = trace.stamps()
    assert [(n, k) for n, k, _ in stamps] == [
        (n, k) for n in SERVE_REGIONS for k in ('enter', 'exit')]
    times = [t for _, _, t in stamps]
    assert times == sorted(times)
    ranges = {e.name for e in prof.events()}
    assert {'exposure.serve.call', 'exposure.serve.deliver'} <= ranges
    assert ('exposure.serve.upload' in ranges) == graphs


def test_fused_chunk_stamps_phases_and_adam(traced):
    cfg = load_config('test')
    cfg.update(batch_size=4, replay_memory_size=8, giters=1, citers=5)
    filters, policy, critic, value = build_models(cfg)
    state = init_train_state(cfg, policy, critic, value, seed=0)
    g = torch.Generator().manual_seed(0)
    fake = torch.rand((8, 80, 80, 3), generator=g)
    real = torch.rand((8, 64, 64, 3), generator=g)
    pool = PoolState.create(torch.rand((8, 64, 64, 3), generator=g),
                            cfg.num_state_dim)
    gen = torch.Generator()

    def draws_for(it):
        gen.manual_seed(it)
        return Draws(gen)

    runner = build_fused_iterations_step(
        cfg, policy, critic, value, filters, (64, True), (64, True), 1, 5,
        draws_for, gen)
    runner.run(state, pool, (fake, real), [7, 8], [1e-4] * 2, [1e-4] * 2,
               [0.5] * 2)
    pairs = _pairs(trace.stamps())
    phases = [p for p in pairs if p[3] == 0]
    assert [p[0] for p in phases] == ['train.generator', 'train.critic'] * 2
    adam = [p for p in pairs if p[0] == 'train.adam']
    assert len(adam) == 12 and len(pairs) == 16
    for name, t0, t1, _ in phases:
        inside = [a for a in adam if t0 <= a[1] and a[2] <= t1]
        assert len(inside) == (1 if name == 'train.generator' else 5)
        assert all(a[3] == 1 for a in inside)


def test_a_full_ring_counts_what_it_drops(traced, monkeypatch):
    monkeypatch.setattr(trace, 'CAPACITY', 3)
    for name in ('a', 'b'):
        with trace.region(name, 'cpu'):
            pass
    assert [(n, k) for n, k, _ in trace.stamps()] == [
        ('a', 'enter'), ('a', 'exit'), ('b', 'enter')]
    assert trace.dropped() == 1
    trace.reset()
    assert trace.stamps() == [] and trace.dropped() == 0


def _event(name, start, end, device=True, annotation=False):
    return types.SimpleNamespace(
        name=name, is_user_annotation=annotation,
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU),
        time_range=types.SimpleNamespace(start=start, end=end))


def test_union_counts_overlaps_once():
    assert union_us([]) == 0
    assert union_us([(0, 10), (5, 12), (20, 25), (21, 22), (25, 30)]) == 22
    assert union_us([(3, 4), (0, 10)]) == 10


def test_device_work_leaves_out_mirrored_host_ranges():
    events = [_event('kernel_a', 0, 10), _event('kernel_b', 5, 15),
              _event('Memcpy DtoD', 20, 22),
              # the profiler's device copies of host ranges
              _event('exposure.fused.run', 0, 40),
              _event('bench.dispatch', 0, 40, annotation=True),
              _event('my_range', 30, 40, annotation=True),
              # host events never count
              _event('cudaLaunchKernel', 0, 50, device=False)]
    work, busy = device_work(events)
    assert [e.name for e in work] == ['kernel_a', 'kernel_b', 'Memcpy DtoD']
    assert busy == 17


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
def test_captured_regions_stamp_every_replay(card, traced):
    pipe = _pipe('cuda')
    images = _images(128, 512, 512, 'cuda')
    graph = pipe._graph(pipe._batch, images)
    graph.run(images, 0)             # the warm-up and the capture
    graph.run(graph.input, 1)
    torch.cuda.synchronize()
    trace.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(3):
        graph.run(graph.input, 2 + i)
    end.record()
    end.synchronize()
    stamps = trace.stamps()
    assert [(n, k) for n, k, _ in stamps] == [
        (n, k) for n in SERVE_REGIONS for k in ('enter', 'exit')] * 3
    assert trace.dropped() == 0
    pairs = _pairs(stamps)
    regions_ms = sum(t1 - t0 for _, t0, t1, _ in pairs) / 1e6
    events_ms = start.elapsed_time(end)
    assert abs(regions_ms - events_ms) <= 0.02 * events_ms, \
        (regions_ms, events_ms)
    pipe.release()


@pytest.mark.cuda
@pytest.mark.parametrize('on', [False, True])
def test_a_graph_captured_untraced_holds_no_stamp(card, on):
    was = trace.enable(on)
    try:
        pipe = _pipe('cuda')
        images = _images(8, 64, 64, 'cuda')
        graph = pipe._graph(pipe._batch, images)
        graph.run(images, 0)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            graph.run(graph.input, 1)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert any('dyn_chain_kernel' in n for n in names)
        assert any('trace_stamp' in n for n in names) == on
        pipe.release()
    finally:
        trace.enable(was)
        trace.reset()
