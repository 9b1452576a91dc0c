"""Dynamic filter-chain replay: the port of the TPU kernel
``_dyn_chain_kernel`` / ``pallas_apply_filter_chain_dynamic``
(``exposure_tpu/ops/pallas_chain.py``).

``apply_filter_chain_dynamic`` applies a K-step chain with per-image ids,
running only each image's selected branch.  On a CUDA tensor it launches
the hand-written kernel ``csrc/dyn_chain.cu`` (one launch for the whole
batch) or raises; on a CPU tensor it runs the plain PyTorch version
``apply_filter_chain_dynamic_reference`` in this module, which groups the
images of each step by id and applies the same branch math.

The branch math below mirrors the kernels' device functions
(``csrc/chain_branches.cuh``): the exact set (``_exposure`` ...
``_saturation``), the fast set that the serving path uses (``_gamma_fast``,
``_saturation_fast``, ``_contrast_fast``, the max-form curves) and the two
mask blends.  Each branch takes planar ``r, g, b`` of shape [n, H, W] and
``p``, a sequence of per-image scalars shaped [n, 1, 1], all float32 or
all bfloat16; in bfloat16 each constant is rounded first (``_c``), as the
switch kernel's bf16 branch set does.  The switch and static chains
(``ops/switch_chain.py``, ``ops/static_chain.py``) share this math and
the helpers below.
"""

import ctypes
import math

import torch

from exposure_tpu_torch.ops import fastmath as fm
from exposure_tpu_torch.ops.filters import max_filter_parameters

_c = fm.const

# Branch codes shared with csrc/dyn_chain.cu (enum Branch).
BRANCH_CODES = {
    'ExposureFilter': 0,
    'GammaFilter': 1,
    'ImprovedWhiteBalanceFilter': 2,
    'SaturationPlusFilter': 3,
    'ToneFilter': 4,
    'ContrastFilter': 5,
    'WNBFilter': 6,
    'ColorFilter': 7,
    'LevelFilter': 8,
    'VignetFilter': 9,
}
IDENTITY_CODE = 10         # kIdentity
MAX_FILTERS = 32           # kMaxFilters in the kernels
MAX_STATIC_SMEM = 48 * 1024


def plan_smem_bytes(num_steps, curve_steps):
    """Shared memory of a chain kernel's block (``plan_smem_bytes`` in
    ``csrc/chain_branches.cuh``): K branch codes and K per-step plans of
    three curves (``curve_steps + 3`` floats each) and six mask scalars."""
    return num_steps * 4 * (1 + 3 * (curve_steps + 3) + 6)


def check_plan_smem(num_steps, filters):
    """Raise when K steps' plans do not fit the kernel's shared memory."""
    steps = int(filters[0].cfg.curve_steps)
    if steps <= 0:
        raise ValueError('curve_steps must be positive, got %d' % steps)
    if plan_smem_bytes(num_steps, steps) > MAX_STATIC_SMEM:
        raise ValueError('K = %d steps of %d-knot curves do not fit the '
                         'kernel\'s shared memory' % (num_steps, steps))


# Operations a pixel of each branch runs in one step (the per-pixel code
# of csrc/chain_branches.cuh; the per-step plan, made once per block, is
# not counted).  Convention: add, subtract, multiply, min, max, abs,
# compare, select, divide and a conversion count 1, an FMA 2, a library
# transcendental (expf, exp2f, log2f, powf, cospif) 1.
def _curve_ops(fast, steps):
    # max form: max, mul; (steps - 1) x (max, FMA); max, FMA; add, mul.
    # clip form: steps x (sub, max, min, FMA); mul
    return 3 * steps + 4 if fast else 5 * steps + 1


def branch_ops(name, fast, steps):
    """Operations one pixel of filter ``name``'s branch runs in one step
    (a curve step is 3 curves of ``steps`` knots)."""
    curve = 3 * _curve_ops(fast, steps)
    return {
        'ExposureFilter': 3,                      # 3 mul
        'GammaFilter': 12 if fast else 6,         # max, log2f, mul, exp2f
        'ImprovedWhiteBalanceFilter': 3,          # 3 mul
        'SaturationPlusFilter': 49 if fast else 48,   # HSV round trip
        'ToneFilter': curve,
        'ContrastFilter': 32 if fast else 25,     # lum, half-cos, divide
        'WNBFilter': 14,                          # lum, 3 x (sub, FMA)
        'ColorFilter': curve,
        'LevelFilter': 12,                        # 3 x (sub, mul, max, min)
        'VignetFilter': 17,                       # its own mask (masked only)
    }[name]


MASK_BLEND_OPS = 30   # lum, the mask's input, sigmoid, strength, 3 blends
MASK_GRID_OPS = 6     # a pixel's gx, gy: 2 x (add, divide, sub)
U8_IO_OPS = 6         # a u8 value: convert, mul in; min, max, mul, round out

# Operations a value of each probe op (csrc/probes.cu: K4a mono_probe, K4b
# fastmath_probe, K4c bf16_probe) runs in one step, in the convention above
# (a bit operation counts 1 too).
PROBE_OPS = {
    'mono_probe': {'copy': 0, 'E': 1, 'G': 2},
    'fastmath_probe': {
        'copy': 0, 'pow_builtin': 2, 'pow_fast': 36, 'pow_exp2log2': 4,
        'pow_explog': 4, 'cos_builtin': 6, 'cos_fast': 13, 'div_builtin': 2,
        'div_fast': 12, 'curve_clip': 41, 'curve_relu': 28},
    'bf16_probe': {'mul': 1, 'pow': 2, 'cos': 16, 'curve': 28},
}


def probe_cost(kernel, op, steps, n):
    """``{'flops', 'bytes'}`` of probe ``kernel``'s op ``op`` run ``steps``
    times on ``n`` u8 values: each value read and written once, its
    ``PROBE_OPS`` per step and its u8 conversions."""
    return {'flops': n * (steps * PROBE_OPS[kernel][op] + U8_IO_OPS),
            'bytes': 2 * n}


def chain_cost(ids, filters, h, w, dtype, fast, masked):
    """``{'flops', 'bytes'}`` that a chain over these inputs needs.

    ``ids``: the [K, n] filter ids of the n images replayed (any id outside
    the bank, or an inactive step folded to one, is the identity and costs
    nothing); ``dtype``: the image type, uint8 or float32.  Bytes count
    each input read once (images, ids, the [K, n, P] parameters and, when
    masking, 6 mask parameters a step) and each output written once;
    operations are ``branch_ops`` per pixel of each step the ids run, the
    mask blend and grid when masking, and the u8 conversions."""
    ids = torch.as_tensor(ids).to(torch.int64).cpu()
    k, n = ids.shape
    steps = int(filters[0].cfg.curve_steps)
    uses = torch.bincount(ids[(ids >= 0) & (ids < len(filters))].flatten(),
                          minlength=len(filters)).tolist()
    ops = 0   # a pixel's operations, summed over every image's steps
    for f, used in zip(filters, uses):
        name = type(f).__name__
        ops += used * (branch_ops(name, fast, steps) + (
            MASK_BLEND_OPS if masked and name != 'VignetFilter' else 0))
    pixels = h * w
    item = torch.empty((), dtype=dtype).element_size()
    flops = ops * pixels + n * pixels * (
        (MASK_GRID_OPS if masked else 0) +
        (3 * U8_IO_OPS if dtype == torch.uint8 else 0))
    p = max_filter_parameters(filters) + (6 if masked else 0)
    nbytes = 2 * n * pixels * 3 * item + k * n * 4 + k * n * p * 4
    return {'flops': int(flops), 'bytes': int(nbytes)}


def _lum(r, g, b):
    return _c(0.27, r) * r + _c(0.67, r) * g + _c(0.06, r) * b


def _exposure(r, g, b, p):
    m = torch.exp(p[0] * _c(math.log(2.0), r))
    return r * m, g * m, b * m


def _gamma(r, g, b, p):
    gm = p[0]
    lo = _c(0.001, r)
    return tuple(torch.pow(torch.clamp(c, min=lo), gm) for c in (r, g, b))


def _gamma_fast(r, g, b, p):
    """exp2(g log2 x): the same function as pow on the clamped input."""
    gm = p[0]
    lo = _c(0.001, r)
    return tuple(torch.exp2(gm * torch.log2(torch.clamp(c, min=lo)))
                 for c in (r, g, b))


def _white_balance(r, g, b, p):
    return r * p[0], g * p[1], b * p[2]


def _curve_apply(x, p, offset, steps):
    psum = _c(1e-30, x)
    for i in range(steps):
        psum = psum + p[offset + i]
    total = x * 0
    width = _c(1.0 / steps, x)
    for i in range(steps):
        total = total + torch.clamp(x - _c(i / steps, x), 0.0, width) * \
            p[offset + i]
    return total * (steps / psum)


def _curve_fast_apply(x, p, offset, steps):
    psum = _c(1e-30, x)
    for i in range(steps):
        psum = psum + p[offset + i]
    knots = [p[offset + i] for i in range(steps)]
    return fm.curve_relu(x, knots, steps / psum)


def _tone(curve, steps):
    def fn(r, g, b, p):
        return (curve(r, p, 0, steps), curve(g, p, 0, steps),
                curve(b, p, 0, steps))
    return fn


def _color(curve, steps):
    def fn(r, g, b, p):
        return (curve(r, p, 0, steps), curve(g, p, steps, steps),
                curve(b, p, 2 * steps, steps))
    return fn


def _contrast_with(half_cos):
    def fn(r, g, b, p):
        lum = torch.clamp(_lum(r, g, b), 0.0, 1.0)
        scale = half_cos(lum) / (lum + _c(1e-6, lum))
        t = p[0]
        return (r + (r * scale - r) * t, g + (g * scale - g) * t,
                b + (b * scale - b) * t)
    return fn


def _exact_half_cos_pi(lum):
    return -torch.cos(_c(math.pi, lum) * lum) * 0.5 + 0.5


def _bw(r, g, b, p):
    lum = _lum(r, g, b)
    t = p[0]
    return r + (lum - r) * t, g + (lum - g) * t, b + (lum - b) * t


def _level(r, g, b, p):
    lo = p[0]
    hi = p[1] + 1.0
    inv = 1.0 / (hi - lo + _c(1e-6, r))
    return tuple(torch.clamp((c - lo) * inv, 0.0, 1.0) for c in (r, g, b))


def _saturation_with(gray_band):
    """S+ as a channel-wise HSV round trip with one divide.  With value v
    and boost weight k, s2 * v = (1 - k) * rng + k * v and the gray
    (hue 0) path gives (v, vg, vg) with vg = (1 - k) * (v - rng).
    ``gray_band`` 0 is the exact test ``rng <= 0``; the fast set pins
    chroma below 2e-4 of v to the gray path, because upstream fast-math
    differences would otherwise move manufactured exact-gray pixels across
    the hue discontinuity."""

    def fn(r, g, b, p):
        r1 = torch.clamp(r, max=1.0)
        g1 = torch.clamp(g, max=1.0)
        b1 = torch.clamp(b, max=1.0)
        v = torch.maximum(torch.maximum(r1, g1), b1)
        mn = torch.minimum(torch.minimum(r1, g1), b1)
        rng = v - mn
        k = (0.5 - torch.abs(0.5 - v)) * _c(0.8, v)
        one_m_k = 1.0 - k
        vpos = v > 0
        safe_v = torch.where(vpos, v, torch.ones_like(v))
        rng_pos = torch.where(vpos, rng, torch.zeros_like(rng))
        gray = rng <= _c(gray_band, v) * safe_v if gray_band else rng <= 0
        ratio = (one_m_k * rng_pos + k * safe_v) / \
            torch.where(gray, torch.ones_like(rng), rng)
        vg = one_m_k * (v - rng_pos)
        t = p[0]

        def enhance(c, gray_val):
            full = torch.where(gray, gray_val, v - (v - c) * ratio)
            return c * (1.0 - t) + full * t

        return enhance(r1, v), enhance(g1, vg), enhance(b1, vg)

    return fn


def _impl(fast, steps):
    curve = _curve_fast_apply if fast else _curve_apply
    return {
        'ExposureFilter': _exposure,
        'GammaFilter': _gamma_fast if fast else _gamma,
        'ImprovedWhiteBalanceFilter': _white_balance,
        'SaturationPlusFilter': _saturation_with(2e-4 if fast else 0.0),
        'ToneFilter': _tone(curve, steps),
        'ContrastFilter': _contrast_with(
            fm.fast_half_cos_pi if fast else _exact_half_cos_pi),
        'WNBFilter': _bw,
        'ColorFilter': _color(curve, steps),
        'LevelFilter': _level,
    }


def _with_mask(fn, mask_offset, cfg):
    """Blend a branch in by the 6-parameter spatial mask; the mask
    parameters sit at ``mask_offset`` in the row."""
    fir = 5.0  # filter_input_range

    def run(r, g, b, p, gx, gy):
        r2, g2, b2 = fn(r, g, b, p)
        # tanh_range(-5, 5, initial=0)(x) == tanh(x) * 5
        mp = [torch.tanh(p[mask_offset + j]) * fir for j in range(6)]
        inp = (gx * mp[0] + gy * mp[1] + mp[2] * (_lum(r, g, b) - 0.5) +
               mp[3] * 2)
        inp = inp * (_c(cfg.maximum_sharpness, r) * mp[4] / fir)
        mask = torch.sigmoid(inp)
        mask = mask * (mp[5] / fir * 0.5 + 0.5) * \
            _c(1 - cfg.minimum_strength, r) + _c(cfg.minimum_strength, r)
        return (r + (r2 - r) * mask, g + (g2 - g) * mask,
                b + (b2 - b) * mask)

    return run


def _vignet_masked(cfg, mask_offset):
    """Elliptical 5-parameter mask blending toward black."""
    fir = 5.0

    def run(r, g, b, p, gx, gy):
        mp = [torch.tanh(p[mask_offset + j]) * fir for j in range(5)]
        inp = (gx * mp[0]) ** 2 + (gy * mp[1]) ** 2 + mp[2] - fir
        inp = inp * (_c(cfg.maximum_sharpness, r) * mp[3] / fir)
        mask = torch.sigmoid(inp) * (mp[4] / fir * 0.5 + 0.5)
        inv = 1.0 - mask
        return r * inv, g * inv, b * inv

    return run


def planar_branches(filters, mask_offset=None, fast_math=False):
    """One branch per filter, each ``(r, g, b, p, gx, gy) -> (r, g, b)``;
    the identity is not listed (an id past the end skips the step)."""
    impl = _impl(fast_math, filters[0].cfg.curve_steps)
    branches = []
    for f in filters:
        name = type(f).__name__
        if name not in BRANCH_CODES:
            raise NotImplementedError(
                'the chain kernel does not support %s' % name)
        if f.use_masking():
            if mask_offset is None:
                raise ValueError('masked filters need mask_params')
            if name == 'VignetFilter':
                branches.append(_vignet_masked(f.cfg, mask_offset))
            else:
                branches.append(_with_mask(impl[name], mask_offset, f.cfg))
        else:
            if name == 'VignetFilter':
                raise NotImplementedError(
                    'VignetFilter without masking zeroes the image; use '
                    'the branchless chain')
            branches.append(
                lambda r, g, b, p, gx, gy, fn=impl[name]: fn(r, g, b, p))
    return branches


def fold_active(filter_ids, active_steps, n_filters):
    """[K, B] ids with inactive steps (``active_steps`` 0) set to the
    identity id ``n_filters``."""
    if active_steps is None:
        return filter_ids
    return torch.where(active_steps > 0, filter_ids,
                       torch.full_like(filter_ids, n_filters))


def _pack(filter_ids, packed_params, filters, active_steps, mask_params):
    """[K, B] ids and [K, B, P] params -> the kernel's [B, K] int32 ids
    (inactive steps folded to the identity id) and [B, K, P'] f32 rows
    (mask parameters appended when masking is on)."""
    masking = any(f.use_masking() for f in filters)
    ids = fold_active(filter_ids, active_steps, len(filters))
    params = packed_params
    if masking:
        if mask_params is None:
            raise ValueError('masking filters require mask_params')
        params = torch.cat([params, mask_params], dim=-1)
    return (ids.transpose(0, 1).to(torch.int32).contiguous(),
            params.transpose(0, 1).to(torch.float32).contiguous(), masking)


def check_image(img):
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError('img must be [B, H, W, 3], got %s'
                         % (tuple(img.shape),))
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError('img must be uint8 or float32, got %s' % img.dtype)


def check_inputs(img, filter_ids, packed_params, active_steps, mask_params):
    """Validate a chain call: [B, H, W, 3] image, [K, B] integer ids,
    [K, B, P] params and the optional [K, B, ...] tensors, all on the
    image's device."""
    check_image(img)
    k, b = filter_ids.shape
    if b != img.shape[0]:
        raise ValueError('filter_ids [K, B] disagrees with the batch: '
                         '%s vs %d' % (tuple(filter_ids.shape), img.shape[0]))
    if filter_ids.dtype.is_floating_point:
        raise TypeError('filter_ids must be integer, got %s'
                        % filter_ids.dtype)
    check_params(img, k, packed_params, active_steps=active_steps,
                 mask_params=mask_params, filter_ids=filter_ids)


def check_params(img, k, packed_params, **optional):
    """[K, B, P] params and optional [K, B, ...] tensors on img's device."""
    b = img.shape[0]
    if packed_params.dim() != 3 or tuple(packed_params.shape[:2]) != (k, b):
        raise ValueError('packed_params must be [K, B, P], got %s'
                         % (tuple(packed_params.shape),))
    for name, t in optional.items():
        if t is not None and tuple(t.shape[:2]) != (k, b):
            raise ValueError('%s must lead with [K, B] = %s, got %s'
                             % (name, (k, b), tuple(t.shape)))
    for name, t in dict(optional, packed_params=packed_params).items():
        if t is not None and t.device != img.device:
            raise ValueError('%s is on %s, img on %s'
                             % (name, t.device, img.device))


def replay_slots(img, rows, n_active):
    """``(indices, n, n_active)``: the image indices a chain call with
    optional ``rows`` and ``n_active`` replays (``rows[:n_active]``, or the
    first ``n_active`` images without ``rows``), its slot count and its
    validated ``n_active``."""
    n = img.shape[0] if rows is None else rows.shape[0]
    n_active = n if n_active is None else int(n_active)
    if not 0 <= n_active <= n:
        raise ValueError('n_active must be in [0, %d], got %d'
                         % (n, n_active))
    if rows is None:
        return torch.arange(n_active, device=img.device), n, n_active
    return rows[:n_active].long(), n, n_active


def check_rows(img, rows, out):
    if rows is not None:
        if rows.dim() != 1 or rows.dtype not in (torch.int32, torch.int64):
            raise TypeError('rows must be a 1-d integer tensor, got %s %s'
                            % (rows.dtype, tuple(rows.shape)))
        if rows.device != img.device:
            raise ValueError('rows is on %s, img on %s'
                             % (rows.device, img.device))
    if out is not None and (out.shape != img.shape or
                            out.dtype != img.dtype or
                            out.device != img.device):
        raise ValueError('out must match img: %s %s on %s'
                         % (tuple(img.shape), img.dtype, img.device))


def mask_grid(h, w, device, dtype=torch.float32):
    """The normalized centered mask grid, x over rows and y over columns,
    computed in float32 and cast to ``dtype``: ([1, H, 1], [1, 1, W])."""
    shorter = float(min(h, w))
    rows = torch.arange(h, dtype=torch.float32, device=device)
    cols = torch.arange(w, dtype=torch.float32, device=device)
    gx = (rows + (shorter - h) / 2.0) / shorter - 0.5
    gy = (cols + (shorter - w) / 2.0) / shorter - 0.5
    return gx[None, :, None].to(dtype), gy[None, None, :].to(dtype)


def to_planes(img, dtype=torch.float32):
    """[n, H, W, 3] u8 or f32 -> three [n, H, W] planes in ``dtype``: u8
    is dequantized in float32 (x / 255) and then cast."""
    x = img.to(torch.float32)
    if img.dtype == torch.uint8:
        x = x * (1.0 / 255.0)
    x = x.to(dtype)
    return tuple(x[..., c].contiguous() for c in range(3))


def from_planes(r, g, b, dtype):
    """Three planes -> [n, H, W, 3] of ``dtype``; u8 is quantized from the
    float32 value (round half to even of clip(x, 0, 1) * 255)."""
    y = torch.stack([r, g, b], dim=-1).to(torch.float32)
    if dtype == torch.uint8:
        return torch.round(torch.clamp(y, 0.0, 1.0) * 255.0).to(torch.uint8)
    return y.to(dtype)


def run_steps(r, g, b, ids, params, branches, gx, gy):
    """Apply ``ids`` [n, K] (identity outside the branch list) with rows
    ``params`` [n, K, P'] to the planes: per step, the images of each id
    go through that branch together."""
    for k in range(ids.shape[1]):
        for fid, branch in enumerate(branches):
            sel = torch.nonzero(ids[:, k] == fid).squeeze(1)
            if sel.numel() == 0:
                continue
            p = params[sel, k][:, :, None, None].unbind(1)
            out = branch(r[sel], g[sel], b[sel], p, gx, gy)
            r[sel], g[sel], b[sel] = out
    return r, g, b


def branch_codes(filters):
    """The bank's branch codes as the C ``int[]`` the kernels take."""
    if len(filters) > MAX_FILTERS:
        raise ValueError('at most %d filters' % MAX_FILTERS)
    return (ctypes.c_int * len(filters))(
        *[BRANCH_CODES[type(f).__name__] for f in filters])


def kernel_scalars(filters, h, w):
    """The config and grid scalars every chain kernel takes after its
    flags: curve_steps, max_sharpness, min_strength, 1 - min_strength,
    shorter side and the two grid offsets."""
    cfg = filters[0].cfg
    shorter = float(min(h, w))
    return (int(cfg.curve_steps), float(cfg.maximum_sharpness),
            float(cfg.minimum_strength), float(1 - cfg.minimum_strength),
            shorter, (shorter - h) / 2.0, (shorter - w) / 2.0)


def kernel_stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def apply_filter_chain_dynamic_reference(img, filter_ids, packed_params,
                                         filters, active_steps=None,
                                         mask_params=None, fast_math=False):
    """Plain PyTorch version of the kernel, on any device: for each step,
    group the images by filter id and run that branch on the group."""
    check_inputs(img, filter_ids, packed_params, active_steps, mask_params)
    ids, params, masking = _pack(filter_ids, packed_params, filters,
                                 active_steps, mask_params)
    max_p = packed_params.shape[-1]
    branches = planar_branches(filters, max_p if masking else None,
                               fast_math)
    r, g, b = to_planes(img)
    gx, gy = mask_grid(img.shape[1], img.shape[2], img.device) \
        if masking else (None, None)
    r, g, b = run_steps(r, g, b, ids, params, branches, gx, gy)
    return from_planes(r, g, b, img.dtype)


def apply_filter_chain_dynamic(img, filter_ids, packed_params, filters,
                               active_steps=None, mask_params=None,
                               fast_math=False):
    """Replay a K-step trajectory with per-image dynamic ids.

    Args:
      img: [B, H, W, 3] uint8 or float32 (linear [0, 1] domain).
      filter_ids: [K, B] integer ids into ``filters``; ``len(filters)``
        (or any id outside the bank) is the identity.
      packed_params: [K, B, P] float32 regressed parameters.
      filters: the instantiated bank (``ops.filters.build_filters``).
      active_steps: optional [K, B] 0/1 mask; inactive steps are identity.
      mask_params: [K, B, M] raw mask parameters, required when masking.
      fast_math: the fast branch set (polynomial cos, exp2/log2 gamma,
        max-form curves, widened S+ gray band).

    Returns:
      [B, H, W, 3] of the input's dtype.  A CPU tensor runs the plain
      PyTorch version; a CUDA tensor launches the kernel or raises.  Any
      batch size is taken: the kernel launcher splits batches larger than
      the grid's 65535 images into several launches.
    """
    if img.device.type == 'cpu':
        return apply_filter_chain_dynamic_reference(
            img, filter_ids, packed_params, filters,
            active_steps=active_steps, mask_params=mask_params,
            fast_math=fast_math)
    if img.device.type != 'cuda':
        raise ValueError('no chain kernel for device %s' % img.device)
    check_inputs(img, filter_ids, packed_params, active_steps, mask_params)
    if not img.is_contiguous():
        raise ValueError('img must be contiguous')
    if packed_params.dtype != torch.float32 or (
            mask_params is not None and mask_params.dtype != torch.float32):
        raise TypeError('params must be float32')
    ids, params, masking = _pack(filter_ids, packed_params, filters,
                                 active_steps, mask_params)
    # validates the bank (unsupported filters raise here, as on the CPU)
    planar_branches(filters, packed_params.shape[-1] if masking else None)
    batch, h, w, _ = img.shape
    num_steps, width = ids.shape[1], params.shape[-1]
    codes = branch_codes(filters)
    if masking and width - packed_params.shape[-1] < 6:
        raise ValueError('the kernel reads 6 mask parameters per step')
    check_plan_smem(num_steps, filters)
    out = torch.empty_like(img)
    from exposure_tpu_torch.kernels import dyn_chain_library
    lib = dyn_chain_library()
    with torch.cuda.device(img.device):
        err = lib.dyn_chain_launch(
            img.data_ptr(), out.data_ptr(), ids.data_ptr(), params.data_ptr(),
            codes, len(filters), batch, h, w, num_steps, width,
            packed_params.shape[-1], int(img.dtype == torch.uint8),
            int(bool(fast_math)), int(masking),
            *kernel_scalars(filters, h, w), kernel_stream(img.device))
    if err != 0:
        raise RuntimeError('dyn_chain kernel launch failed: %s'
                           % lib.dyn_chain_error_string(err).decode())
    apply_filter_chain_dynamic.launches += 1
    return out


# Kernel launches by apply_filter_chain_dynamic (CPU calls do not count).
apply_filter_chain_dynamic.launches = 0
