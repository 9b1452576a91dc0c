"""The probe kernels' plain versions (K4a ``mono_chain``, K4b ``run_op``,
K4c ``run_probe``) against the JAX tools' kernel bodies, on the CPU.

The JAX tools' wrappers take no ``interpret`` flag (``probe`` returns only
a time), so each test builds a ``pl.pallas_call(..., interpret=True)``
around the JAX module's own kernel body, with one block per image of a
small batch.  The JAX call is compiled with ``xla_allow_excess_precision``
off: otherwise XLA on the CPU drops the bf16 roundings between operations
and computes a bf16 chain in f32, which neither the TPU kernel nor the
port does.

Tolerances, in u8 LSB: 0 for the exact ops; 1 for pow, cos and exp, whose
f32 library calls may differ in the last bit between XLA and torch, and
for E, because XLA folds ``x * (1/255) * 1.5`` into one multiply, which
moves the round-half-to-even ties of 1.5 v for odd v."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from exposure_tpu.tools import bench_bf16_probe as j_bf16
from exposure_tpu.tools import bench_fastmath as j_fastmath
from exposure_tpu.tools import bench_kernel_probe as j_probe
from exposure_tpu_torch.tools import bench_bf16_probe as t_bf16
from exposure_tpu_torch.tools import bench_fastmath as t_fastmath
from exposure_tpu_torch.tools import bench_kernel_probe as t_probe

SHAPE = (2, 3, 32, 128)   # planar [B, C, H, W] u8


def _pallas(kernel, img, params=None):
    """The JAX kernel body over ``img`` [B, C, H, W] u8, one block per
    image, in interpret mode; ``params`` go to SMEM as K4c's do."""
    b, c, h, w = img.shape
    spec = pl.BlockSpec((1, c, h, w), lambda i: (i, 0, 0, 0))
    in_specs, args = [spec], [jnp.asarray(img)]
    if params is not None:
        in_specs = [pl.BlockSpec(memory_space=pltpu.SMEM), spec]
        args = [jnp.asarray(params, jnp.float32)] + args
    call = jax.jit(lambda *a: pl.pallas_call(
        kernel, grid=(b,), in_specs=in_specs, out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(img.shape, jnp.uint8),
        interpret=True)(*a))
    compiled = call.lower(*args).compile(
        compiler_options={'xla_allow_excess_precision': False})
    return np.asarray(compiled(*args))


def _image(channels):
    rng = np.random.RandomState(0)
    return (rng.rand(SHAPE[0], channels, *SHAPE[2:]) * 255).astype(np.uint8)


def _lsb(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.dtype == np.uint8 and got.shape == want.shape
    return int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())


@pytest.mark.parametrize('steps', [0, 1, 5])
@pytest.mark.parametrize('op', t_probe.MONO_OPS)
def test_mono_chain_matches_jax(op, steps):
    img = _image(3)
    want = _pallas(functools.partial(j_probe._mono_kernel, steps=steps,
                                     op=op), img)
    nhwc = torch.from_numpy(img.transpose(0, 2, 3, 1).copy())
    got = t_probe.mono_chain(nhwc, steps, op).numpy().transpose(0, 3, 1, 2)
    assert _lsb(got, want) <= (0 if op == 'copy' or steps == 0 else 1)


@pytest.mark.parametrize('op', list(t_fastmath.OPS))
def test_run_op_matches_jax(op):
    assert list(t_fastmath.OPS) == list(j_fastmath.OPS)
    img = _image(3)
    want = _pallas(functools.partial(j_fastmath._kernel,
                                     op=j_fastmath.OPS[op]), img)
    got = t_fastmath.run_op(torch.from_numpy(img), op)
    exact = op in ('copy', 'div_builtin', 'div_fast', 'curve_clip',
                   'curve_relu')
    assert _lsb(got, want) <= (0 if exact else 1)


@pytest.mark.parametrize('style', t_bf16.STYLES)
@pytest.mark.parametrize('op', t_bf16.OPS)
def test_run_probe_matches_jax(op, style):
    img = _image(1)
    want = _pallas(functools.partial(j_bf16._probe_kernel, steps=8, op=op,
                                     style=style), img,
                   params=t_bf16.PARAMS)
    got = t_bf16.run_probe(torch.from_numpy(img), t_bf16.PARAMS, op, style,
                           8)
    assert _lsb(got, want) <= (1 if op in ('pow', 'cos') else 0)


@pytest.mark.parametrize('op', t_bf16.OPS)
def test_bf16_styles_agree(op):
    """bf16_cast and bf16_splat round the same values: the same bits."""
    img = torch.from_numpy(_image(1))
    cast = t_bf16.run_probe(img, t_bf16.PARAMS, op, 'bf16_cast', 8)
    splat = t_bf16.run_probe(img, t_bf16.PARAMS, op, 'bf16_splat', 8)
    assert torch.equal(cast, splat)


def test_cpu_calls_run_the_plain_versions_and_count_nothing():
    img = torch.from_numpy(_image(3))
    before = (t_probe.mono_chain.launches, t_fastmath.run_op.launches,
              t_bf16.run_probe.launches)
    t_probe.mono_chain(img.permute(0, 2, 3, 1).contiguous(), 1, 'E')
    t_fastmath.run_op(img, 'cos_fast')
    t_bf16.run_probe(img[:, :1].contiguous(), t_bf16.PARAMS, 'mul', 'f32', 2)
    assert (t_probe.mono_chain.launches, t_fastmath.run_op.launches,
            t_bf16.run_probe.launches) == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    img = torch.from_numpy(_image(3))
    with pytest.raises(ValueError):
        t_probe.mono_chain(img, 1, 'E')            # planar, not NHWC
    with pytest.raises(ValueError):
        t_probe.mono_chain(img.permute(0, 2, 3, 1), 1, 'exposure')
    with pytest.raises(ValueError):
        t_fastmath.run_op(img, 'tan_fast')
    with pytest.raises(ValueError):
        t_bf16.run_probe(img, t_bf16.PARAMS, 'mul', 'f32', 1)  # 3 channels
    with pytest.raises(ValueError):
        t_bf16.run_probe(img[:, :1], t_bf16.PARAMS, 'mul', 'fp16', 1)
