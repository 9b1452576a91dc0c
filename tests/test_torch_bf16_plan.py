"""The bf16 switch kernel's per-block plan, and the u8 conversions of every
kernel, modelled in torch on the CPU.

``csrc/switch_chain.cu`` computes what does not depend on the pixel once per
block (``plan_step_bf``: E's multiplier, each curve's norm, differences and
C0, Level's reciprocal, S+'s 1 - t, the tanh-mapped mask scalars and their
quotients) and the rest per pixel (``run_step_bf``).  ``_plan`` and ``_apply``
below are those two functions in torch bf16 operations, which round after
every operation as the kernel's arithmetic does.  The tests hold them equal
bit for bit to the plain version
(``apply_filter_chain_switch_reference(compute_dtype=bfloat16)``), which
evaluates every expression per pixel, for one step of every branch of the
``synthetic_explore`` and ``masked`` banks: the hoisting changes no rounding.
That is an argument about the design: the transcription is written here and
reads nothing of the CUDA source, so an edit to the kernel's plan leaves
these tests as they are.  The kernel itself is checked on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` and its ``--turns``).

``csrc/chain_branches.cuh`` converts u8 on the f32 pipe: a byte v enters as
the float with bits ``0x4B000000 | v`` minus 2^23, and a value x in [0, 255]
leaves as the low byte of ``x + 1.5 * 2^23``.  The tests hold both to
``tools.dequantize`` and ``tools.quantize`` (v * (1/255) and round half to
even of clip(x, 0, 1) * 255), over every byte and a dense sweep with every
half."""

import math

import numpy as np
import pytest
import torch

from exposure_tpu_torch.ops import fastmath as fm
from exposure_tpu_torch.ops.dyn_chain import from_planes, mask_grid, to_planes
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.ops.switch_chain import (
    apply_filter_chain_switch_reference,
)
from exposure_tpu_torch.tools import dequantize, quantize
from exposure_tpu_torch.utils.config import load_config

BF16 = torch.bfloat16
FIR = 5.0   # filter_input_range


def _c(value):
    """A constant rounded to bf16, as a Python float."""
    return fm.const(value, torch.zeros((), dtype=BF16))


def _curve_plan(knots, fast):
    """plan_curve_bf: [t.., norm] or [t_0, d_1.., t_last, C0, norm]."""
    steps = len(knots)
    psum = _c(1e-30) + knots[0]
    for t in knots[1:]:
        psum = psum + t
    norm = psum.reciprocal() * _c(steps)
    if not fast:
        return list(knots) + [norm]
    q, c0 = [knots[0]], knots[-1]
    for i in range(1, steps):
        d = knots[i] - knots[i - 1]
        q.append(d)
        c0 = c0 - d * _c(i / steps)
    return q + [knots[-1], c0, norm]


def _curve_apply(x, q, steps, fast):
    """curve_bf2 on a plan."""
    if fast:
        total = torch.clamp(x, min=_c(0.0)) * q[0]
        for i in range(1, steps):
            total = total + torch.clamp(x, min=_c(i / steps)) * q[i]
        total = total - torch.clamp(x, min=_c(1.0)) * q[steps]
        return (total + q[steps + 1]) * q[steps + 2]
    total = x * _c(0.0)
    for i in range(steps):
        total = total + torch.clamp(x - _c(i / steps), _c(0.0),
                                    _c(1.0 / steps)) * q[i]
    return total * q[steps]


def _plan(name, p, mp, cfg, fast, masked):
    """plan_step_bf: the step's scalars, each a [n, 1, 1] bf16 tensor."""
    steps = cfg.curve_steps
    q = {}
    if name == 'ExposureFilter':
        q['m'] = torch.exp(p[0] * _c(math.log(2.0)))
    elif name == 'SaturationPlusFilter':
        q['t'], q['keep'] = p[0], _c(1.0) - p[0]
    elif name == 'ToneFilter':
        q['curves'] = [_curve_plan(p[:steps], fast)] * 3
    elif name == 'ColorFilter':
        q['curves'] = [_curve_plan(p[c * steps:(c + 1) * steps], fast)
                       for c in range(3)]
    elif name == 'LevelFilter':
        q['lo'] = p[0]
        q['inv'] = ((p[1] + _c(1.0)) - p[0] + _c(1e-6)).reciprocal()
    elif name == 'VignetFilter':
        m = [torch.tanh(mp[j]) * _c(FIR) for j in range(5)]
        q['m'] = m[:3]
        q['sharp'] = _c(cfg.maximum_sharpness) * m[3] / _c(FIR)
        q['amp'] = m[4] / _c(FIR) * _c(0.5) + _c(0.5)
        return q
    else:
        q['p'] = p
    if masked:
        m = [torch.tanh(mp[j]) * _c(FIR) for j in range(6)]
        q['mask'] = dict(m=m[:3], m3x2=m[3] * _c(2.0),
                         sharp=_c(cfg.maximum_sharpness) * m[4] / _c(FIR),
                         amp=m[5] / _c(FIR) * _c(0.5) + _c(0.5))
    return q


def _lum(r, g, b):
    return _c(0.27) * r + _c(0.67) * g + _c(0.06) * b


def _branch(name, q, r, g, b, cfg, fast):
    """The unmasked part of run_step_bf's switch."""
    steps = cfg.curve_steps
    if name == 'ExposureFilter':
        return r * q['m'], g * q['m'], b * q['m']
    if name == 'GammaFilter':
        gm = q['p'][0]
        clamped = [torch.clamp(x, min=_c(0.001)) for x in (r, g, b)]
        if fast:
            return tuple(torch.exp2(gm * torch.log2(x)) for x in clamped)
        return tuple(torch.pow(x, gm) for x in clamped)
    if name == 'ImprovedWhiteBalanceFilter':
        return r * q['p'][0], g * q['p'][1], b * q['p'][2]
    if name == 'SaturationPlusFilter':
        one, half, zero = _c(1.0), _c(0.5), _c(0.0)
        r1, g1, b1 = (torch.clamp(x, max=one) for x in (r, g, b))
        v = torch.maximum(torch.maximum(r1, g1), b1)
        mn = torch.minimum(torch.minimum(r1, g1), b1)
        rng = v - mn
        k = (half - torch.abs(half - v)) * _c(0.8)
        one_m_k = one - k
        vpos = v > zero
        safe_v = torch.where(vpos, v, torch.ones_like(v))
        rng_pos = torch.where(vpos, rng, torch.zeros_like(rng))
        gray = rng <= _c(2e-4) * safe_v if fast else rng <= zero
        ratio = (one_m_k * rng_pos + k * safe_v) / torch.where(
            gray, torch.ones_like(rng), rng)
        vg = one_m_k * (v - rng_pos)
        outs = []
        for x1, gray_val in ((r1, v), (g1, vg), (b1, vg)):
            full = torch.where(gray, gray_val, v - (v - x1) * ratio)
            outs.append(x1 * q['keep'] + full * q['t'])
        return tuple(outs)
    if name in ('ToneFilter', 'ColorFilter'):
        return tuple(_curve_apply(x, plan, steps, fast)
                     for x, plan in zip((r, g, b), q['curves']))
    if name == 'ContrastFilter':
        lum = torch.clamp(_lum(r, g, b), _c(0.0), _c(1.0))
        clum = fm.fast_half_cos_pi(lum) if fast else \
            -torch.cos(_c(math.pi) * lum) * _c(0.5) + _c(0.5)
        scale = clum / (lum + _c(1e-6))
        t = q['p'][0]
        return tuple(x + (x * scale - x) * t for x in (r, g, b))
    if name == 'WNBFilter':
        lum, t = _lum(r, g, b), q['p'][0]
        return tuple(x + (lum - x) * t for x in (r, g, b))
    if name == 'LevelFilter':
        return tuple(torch.clamp((x - q['lo']) * q['inv'], _c(0.0), _c(1.0))
                     for x in (r, g, b))
    raise AssertionError(name)


def _apply(name, q, r, g, b, gx, gy, cfg, fast, masked):
    """run_step_bf: the branch, blended by the step's mask when masking."""
    if name == 'VignetFilter':
        ex, ey = gx * q['m'][0], gy * q['m'][1]
        inp = (ex * ex + ey * ey + q['m'][2] - _c(FIR)) * q['sharp']
        inv = _c(1.0) - torch.sigmoid(inp) * q['amp']
        return r * inv, g * inv, b * inv
    if not masked:
        return _branch(name, q, r, g, b, cfg, fast)
    mk = q['mask']
    inp = (gx * mk['m'][0] + gy * mk['m'][1] +
           mk['m'][2] * (_lum(r, g, b) - _c(0.5)) + mk['m3x2']) * mk['sharp']
    mask = torch.sigmoid(inp) * mk['amp'] * _c(1 - cfg.minimum_strength) + \
        _c(cfg.minimum_strength)
    out = _branch(name, q, r, g, b, cfg, fast)
    return tuple(x + (x2 - x) * mask for x, x2 in zip((r, g, b), out))


def _one_step_through_plan(img, fid, params, mask_params, filters, fast):
    """One step of filter ``fid`` on every image: plan, then pixels."""
    f = filters[fid]
    cfg = f.cfg
    masked = f.use_masking()
    p = params[0].to(BF16)[:, :, None, None].unbind(1)
    mp = mask_params[0].to(BF16)[:, :, None, None].unbind(1) if masked \
        else None
    r, g, b = to_planes(img, BF16)
    gx, gy = mask_grid(img.shape[1], img.shape[2], img.device, BF16) \
        if masked else (None, None)
    name = type(f).__name__
    q = _plan(name, p, mp, cfg, fast, masked)
    return from_planes(*_apply(name, q, r, g, b, gx, gy, cfg, fast, masked),
                       img.dtype)


def _bank_cases():
    cases = []
    for config in ('synthetic_explore', 'masked'):
        for fid, f in enumerate(build_filters(load_config(config))):
            cases.append(pytest.param(config, fid,
                                      id='%s-%s' % (config,
                                                    f.get_short_name())))
    return cases


@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('config,fid', _bank_cases())
def test_bf16_plan_matches_per_pixel_reference(config, fid, fast):
    filters = build_filters(load_config(config))
    f = filters[fid]
    rng = np.random.RandomState(100 + fid)
    b = 3
    x = (rng.rand(b, 24, 40, 3) * 1.05).astype(np.float32)
    n = f.get_num_filter_parameters()
    raw = torch.from_numpy(rng.randn(b, n).astype(np.float32))
    params = torch.zeros((1, b, 24))
    params[0, :, :n] = f.filter_param_regressor(raw)
    mask = torch.from_numpy(rng.randn(1, b, 6).astype(np.float32)) \
        if f.use_masking() else None
    ids = torch.full((1, b), fid, dtype=torch.int32)
    for img in (torch.from_numpy(x),
                torch.from_numpy((x * 255).clip(0, 255).astype(np.uint8))):
        want = apply_filter_chain_switch_reference(
            img, ids, params, filters, mask_params=mask,
            compute_dtype=BF16, fast_math=fast)
        got = _one_step_through_plan(img, fid, params, mask, filters, fast)
        assert got.dtype == want.dtype
        assert torch.equal(got, want), (img.dtype, int((got != want).sum()))


def test_u8_load_identity_every_byte():
    """(float with bits 0x4B000000 | v) - 2^23 is v, so the kernels'
    load_px is dequantize bit for bit."""
    v = torch.arange(256, dtype=torch.int32)
    magic = (v | 0x4B000000).view(torch.float32) - 8388608.0
    assert torch.equal(magic, v.to(torch.float32))
    got = magic * (1.0 / 255.0)
    want = dequantize(v.to(torch.uint8))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _magic_quantize(x):
    """quantize_bits: the low byte of clip(x, 0, 1) * 255 + 1.5 * 2^23."""
    scaled = torch.clamp(x, 0.0, 1.0) * 255.0
    return ((scaled + 12582912.0).view(torch.int32) & 0xFF).to(torch.uint8)


def test_u8_store_identity_every_half():
    """x + 1.5 * 2^23 rounds x in [0, 255] half to even into the low
    mantissa byte: every integer, every half and their float neighbours."""
    halves = torch.arange(0, 511, dtype=torch.float32) * 0.5
    near = torch.cat([halves, torch.nextafter(halves, halves + 1),
                      torch.nextafter(halves, halves - 1)]).clamp(0.0, 255.0)
    got = ((near + 12582912.0).view(torch.int32) & 0xFF).to(torch.uint8)
    assert torch.equal(got, torch.round(near).to(torch.uint8))


def test_u8_store_identity_dense_sweep():
    """The kernels' quantize_px against tools.quantize on a dense sweep of
    [-0.1, 1.1], on every x whose product with 255 is an integer or a half,
    and on NaN and the infinities."""
    rng = np.random.RandomState(0)
    dense = torch.linspace(-0.1, 1.1, 2_000_001)
    exact = (torch.arange(0, 511, dtype=torch.float32) * 0.5) / 255.0
    near = torch.cat([exact, torch.nextafter(exact, exact + 1),
                      torch.nextafter(exact, exact - 1)])
    rand = torch.from_numpy(rng.rand(1_000_000).astype(np.float32))
    special = torch.tensor([float('inf'), -float('inf'), 0.0, -0.0, 1.0])
    x = torch.cat([dense, near, rand, special])
    assert torch.equal(_magic_quantize(x), quantize(x))
    # a NaN quantizes to 0 in the kernels (fmaxf returns the other operand)
    bytes_ = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(_magic_quantize(dequantize(bytes_)), bytes_)
