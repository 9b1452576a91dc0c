"""The port's precision contract (``exposure_tpu_torch/utils/precision.py``)
on the CPU: with the process's TF32 flags set on, every convolution and
matmul the port launches for a plan, a training update or a critic score
sees TF32 off, forward and backward, and the flags read on again after.

What a kernel sees is read where it launches, not where the flags are set:
``torch.nn.functional.conv2d`` and ``linear`` are wrapped to record
``tf32_seen()`` (the ``fp32_precision`` leaves that cuDNN and cuBLAS read)
at each forward, and a hook on each output records it again when the
backward reaches that output, and again when a double backward (the WGAN-GP
penalty's) reaches the gradient.  The CPU kernels ignore the flags, so the
card's proof is ``tests/test_torch_cuda.py`` (ids and bits alike under
both settings) and ``chip_smoke.py``; here the contract's reach is held:

- one case an entry point: ``RetouchPipeline`` with the selected plan and
  with the bank plan, ``Evaluator.plan_trajectory`` and ``critic_logits``,
  ``bench_torch.py``'s plan body, a ``build_outer_step`` step (its
  critic's double backward too), a fused chunk
  (``build_fused_iterations_step``), the trainer's grid scores
  (``critic_scores``, ``state_values``, ``critic_gradients``);
- two threads: one holds the contract while another enters and leaves it,
  and the first one's later convolutions still see TF32 off;
- nested blocks restore the flags once, at the outermost exit, also after
  an exception;
- the bf16 plan still runs its convolutions in bfloat16.
"""

import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from exposure_tpu_torch.core.evaluator import Evaluator
from exposure_tpu_torch.core.replay import PoolState
from exposure_tpu_torch.core.serving import RetouchPipeline
from exposure_tpu_torch.core.steps import (
    build_fused_iterations_step,
    build_outer_step,
)
from exposure_tpu_torch.core.train_state import init_train_state
from exposure_tpu_torch.models.networks import build_models
from exposure_tpu_torch.utils.config import load_config
from exposure_tpu_torch.utils.draws import Draws
from exposure_tpu_torch.utils.precision import tf32_off

OFF = (False, False)
ON = (True, True)
META = (64, True)      # the packs' crop size and augmentation


def tf32_seen():
    """(cuDNN convolution, cuBLAS matmul) in TF32 if launched now: the
    ``fp32_precision`` leaves the kernels read, not the flags as set."""
    return (torch.backends.cudnn.conv.fp32_precision == 'tf32',
            torch.backends.cuda.matmul.fp32_precision == 'tf32')


@pytest.fixture
def flags_on():
    """The process's TF32 flags on (the legacy interface, which sets the
    leaves a kernel reads), restored after the test."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    assert tf32_seen() == ON
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


class Launches:
    """What each convolution and matmul saw: ``(pass, op, tf32_seen(),
    dtype, thread)`` with pass ``forward``, ``backward`` or ``double``."""

    def __init__(self):
        self.events = []
        self.lock = threading.Lock()
        self.on_forward = None      # called before a forward, if set

    def add(self, kind, op, dtype=None):
        with self.lock:
            self.events.append((kind, op, tf32_seen(), dtype,
                                threading.get_ident()))

    def wrap(self, real, op):
        def call(x, *args, **kwargs):
            if self.on_forward is not None:
                self.on_forward()
            self.add('forward', op, x.dtype)
            out = real(x, *args, **kwargs)
            if out.requires_grad:
                def on_grad(g):
                    self.add('backward', op)
                    if g.requires_grad:
                        g.register_hook(lambda _: self.add('double', op))
                out.register_hook(on_grad)
            return out
        return call

    def passes(self):
        return {e[0] for e in self.events}

    def seen(self, events=None):
        return {e[2] for e in (self.events if events is None else events)}


@pytest.fixture
def launches(monkeypatch):
    rec = Launches()
    monkeypatch.setattr(F, 'conv2d', rec.wrap(F.conv2d, 'conv'))
    monkeypatch.setattr(F, 'linear', rec.wrap(F.linear, 'matmul'))
    return rec


def _cfg(name='test'):
    cfg = load_config(name)
    cfg.name = name + '/none'
    return cfg


def _u8(n=2, h=48, w=64, seed=3):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               np.uint8)


def _proxies(n=2, seed=11):
    return np.random.RandomState(seed).rand(n, 64, 64, 3).astype(np.float32)


def _state(cfg, nets, seed=0):
    return init_train_state(cfg, *nets[1:], seed=seed)


def _pool(cfg, rng):
    p = cfg.replay_memory_size
    pool = PoolState.create(torch.from_numpy(
        rng.rand(p, 64, 64, 3).astype(np.float32)), cfg.num_state_dim)
    pool.states[::3, 1] = 1.0
    return pool


def _packs(rng):
    return (torch.from_numpy(rng.rand(40, 80, 80, 3).astype(np.float32)),
            torch.from_numpy(rng.rand(40, 64, 64, 3).astype(np.float32)))


# -- one case an entry point ----------------------------------------------
def _pipeline(selected_plan):
    def run():
        cfg = _cfg()
        pipe = RetouchPipeline(cfg, build_models(cfg)[1], device='cpu',
                               use_kernels=True, dynamic=True,
                               selected_plan=selected_plan)
        out = pipe(_u8(), seed=1)
        assert out.shape == (2, 48, 64, 3) and out.dtype == np.uint8
    return run


def _evaluator_plan():
    cfg = _cfg()
    ev = Evaluator(cfg, policy=build_models(cfg)[1], device='cpu')
    traj, applied = ev.plan_trajectory(_proxies())
    assert traj.filter_ids.shape == (cfg.test_steps, 2)


def _evaluator_critic():
    cfg = _cfg()
    ev = Evaluator(cfg, state=_state(cfg, build_models(cfg)), device='cpu')
    assert ev.critic_logits(_proxies()).shape == (2, 1)


def _bench_plan_body():
    import bench_torch
    step_fn, imgs, seed = bench_torch.build_pipeline(2, 64, 'grouped', True,
                                                     device='cpu')
    out = step_fn(imgs, seed)
    assert out.shape == (2, 64, 64, 3) and out.dtype == torch.uint8


def _outer_step():
    cfg = _cfg()
    nets = build_models(cfg)
    rng = np.random.RandomState(5)
    step = build_outer_step(cfg, *nets[1:], nets[0], META, META, 1, 1)
    _, _, metrics = step(_state(cfg, nets), _pool(cfg, rng), *_packs(rng),
                         Draws(torch.Generator().manual_seed(0)), 1e-3, 1e-3,
                         0.3)
    assert all(torch.isfinite(m) for m in metrics)


def _fused_chunk():
    cfg = _cfg()
    nets = build_models(cfg)
    rng = np.random.RandomState(6)

    def draws_for(it):
        return Draws(torch.Generator().manual_seed(it))
    runner = build_fused_iterations_step(cfg, *nets[1:], nets[0], META, META,
                                         1, 1, draws_for)
    _, _, metrics = runner.run(_state(cfg, nets), _pool(cfg, rng),
                               _packs(rng), [5, 6], [1e-3] * 2, [1e-3] * 2,
                               [0.3, 0.31])
    assert metrics.shape == (2, 7) and bool(torch.isfinite(metrics).all())


def _trainer_scores(tmp_path):
    from exposure_tpu_torch.core.trainer import Trainer
    cfg = _cfg()
    trainer = Trainer(cfg, restore=False, model_root=str(tmp_path),
                      device='cpu')
    try:
        imgs = _proxies(3)
        states = np.zeros((3, cfg.num_state_dim), np.float32)
        assert trainer.critic_scores(imgs).shape == (3,)
        assert trainer.state_values(imgs, states).shape == (3,)
        assert trainer.critic_gradients(imgs).shape == imgs.shape
    finally:
        trainer.close()


ENTRY_POINTS = {
    'pipeline_selected_plan': (_pipeline(True), {'forward'}),
    'pipeline_bank_plan': (_pipeline(False), {'forward'}),
    'evaluator_plan_trajectory': (_evaluator_plan, {'forward'}),
    'evaluator_critic_logits': (_evaluator_critic, {'forward'}),
    'bench_torch_plan_body': (_bench_plan_body, {'forward'}),
    'build_outer_step': (_outer_step, {'forward', 'backward', 'double'}),
    'fused_chunk': (_fused_chunk, {'forward', 'backward', 'double'}),
    'trainer_grid_scores': (_trainer_scores, {'forward', 'backward'}),
}


@pytest.mark.parametrize('entry', sorted(ENTRY_POINTS))
def test_entry_point_launches_see_tf32_off(entry, flags_on, launches,
                                           tmp_path):
    run, passes = ENTRY_POINTS[entry]
    if entry == 'trainer_grid_scores':
        run(tmp_path)
    else:
        run()
    assert launches.passes() == passes, launches.passes()
    assert {e[1] for e in launches.events} == {'conv', 'matmul'}
    assert launches.seen() == {OFF}, [e[:3] for e in launches.events
                                      if e[2] != OFF][:5]
    assert tf32_seen() == ON
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.backends.cuda.matmul.allow_tf32 is True


class Paused(threading.Thread):
    """``fn()`` on a thread of its own that stops at its first forward, so
    inside the contract, until ``go`` is set."""

    def __init__(self, fn, launches):
        super().__init__(daemon=True)
        self.fn, self.launches = fn, launches
        self.inside, self.go = threading.Event(), threading.Event()
        self.errors = []

    def run(self):
        try:
            self.fn()
        except BaseException as e:      # raised again in the main thread
            self.errors.append(e)

    def pause(self):
        if threading.get_ident() == self.ident and not self.inside.is_set():
            self.inside.set()
            assert self.go.wait(120)

    def finish(self):
        self.go.set()
        self.join(120)
        assert not self.is_alive() and not self.errors, self.errors

    def events(self):
        return [e for e in self.launches.events if e[4] == self.ident]


@pytest.mark.parametrize('order', ['nested', 'interleaved'])
def test_a_thread_leaving_keeps_the_contract_of_another(flags_on, launches,
                                                        order):
    """Thread A plans, thread B scores the critic; each stops inside the
    contract at its first forward.  ``nested``: A enters, then B enters;
    ``interleaved``: B enters, then A.  B then leaves while A is inside:
    the flags stay off, A's later launches see TF32 off, and they come back
    on when A leaves."""
    cfg = _cfg()
    nets = build_models(cfg)
    planner = Evaluator(cfg, policy=nets[1], device='cpu')
    scorer = Evaluator(cfg, state=_state(cfg, nets), device='cpu')
    a = Paused(lambda: planner.plan_trajectory(_proxies()), launches)
    b = Paused(lambda: scorer.critic_logits(_proxies(3)), launches)
    launches.on_forward = lambda: (a.pause(), b.pause())
    first, second = (a, b) if order == 'nested' else (b, a)
    try:
        for t in (first, second):
            t.start()
            assert t.inside.wait(120)
        b.finish()
        after_b = tf32_seen()
    finally:
        b.go.set()
        a.finish()
    assert after_b == OFF
    assert len(a.events()) > 1 and b.events()
    assert launches.seen(a.events()) == launches.seen(b.events()) == {OFF}
    assert tf32_seen() == ON


def test_nested_blocks_restore_once(flags_on):
    with tf32_off():
        with tf32_off():
            assert tf32_seen() == OFF
        assert tf32_seen() == OFF
        with pytest.raises(RuntimeError):
            with tf32_off():
                raise RuntimeError('inside')
        assert tf32_seen() == OFF
    assert tf32_seen() == ON
    torch.backends.cudnn.allow_tf32 = False   # a process that set it off
    with tf32_off():
        assert tf32_seen() == OFF
    assert tf32_seen() == (False, True)


@pytest.mark.parametrize('selected_plan', [True, False],
                         ids=['selected_plan', 'bank_plan'])
def test_bf16_plan_stays_bf16(flags_on, launches, selected_plan):
    cfg = _cfg()
    pipe = RetouchPipeline(cfg, build_models(cfg)[1], device='cpu',
                           use_kernels=True, dynamic=True,
                           selected_plan=selected_plan, bf16=True)
    proxy = pipe.proxy(torch.from_numpy(_u8()))
    ids, params, mask = pipe.plan(proxy, torch.Generator().manual_seed(1))
    assert ids.shape == (cfg.test_steps, 2) and params.dtype == torch.float32
    dtypes = {e[3] for e in launches.events}
    assert dtypes == {torch.bfloat16}, dtypes
    assert launches.seen() == {OFF}
    assert tf32_seen() == ON
