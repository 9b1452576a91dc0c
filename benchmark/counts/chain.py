"""Operations and bytes of the filter-chain replay (K1), frozen from
``exposure_tpu_torch/ops/dyn_chain.py::chain_cost`` and ``branch_ops`` with
S+ at its traced count: 45 operations a pixel exact and 46 fast
(``tools/branch_roofline.py`` counted the aten operations of the plain
branch as the kernel runs them; the hand count said 48 and 49).

The convention's weakness: a library transcendental (``expf``,
``exp2f``, ``log2f``, ``powf``, ``cospif``) counts 1 like an add, while it
costs the card several instructions, so a branch heavy in them sits far
below its roofline by construction: Gamma (exact) runs 47 times slower a
counted operation than Tone.  A roofline share is therefore a floor for the
transcendental branches, and compares like with like only on the same
branch mix."""

# add, subtract, multiply, min, max, abs, compare, select, divide and a
# conversion count 1, an FMA 2, a library transcendental 1
MASK_BLEND_OPS = 30   # lum, the mask's input, sigmoid, strength, 3 blends
MASK_GRID_OPS = 6     # a pixel's gx, gy: 2 x (add, divide, sub)
U8_IO_OPS = 6         # a u8 value: convert, mul in; min, max, mul, round out


def _curve_ops(fast, steps):
    # max form: max, mul; (steps - 1) x (max, FMA); max, FMA; add, mul.
    # clip form: steps x (sub, max, min, FMA); mul
    return 3 * steps + 4 if fast else 5 * steps + 1


def branch_ops(name, fast, steps):
    """Operations one pixel of filter ``name``'s branch runs in one step
    (a curve step is 3 curves of ``steps`` knots)."""
    curve = 3 * _curve_ops(fast, steps)
    return {
        'ExposureFilter': 3,
        'GammaFilter': 12 if fast else 6,
        'ImprovedWhiteBalanceFilter': 3,
        'SaturationPlusFilter': 46 if fast else 45,
        'ToneFilter': curve,
        'ContrastFilter': 32 if fast else 25,
        'WNBFilter': 14,
        'ColorFilter': curve,
        'LevelFilter': 12,
        'VignetFilter': 17,
    }[name]


def chain_cost(ids, filter_names, curve_steps, max_params, h, w, u8, fast,
               masked):
    """``{'flops', 'bytes'}`` a chain over these inputs needs.

    ``ids``: the ``[K, n]`` filter ids (nested lists or an integer array)
    of the n images replayed; an id outside the bank is the identity and
    costs nothing.  Bytes: each input read once (images, ids, the ``[K, n,
    P]`` parameters and, when masking, 6 mask parameters a step) and each
    output written once.  Operations: ``branch_ops`` per pixel of each step
    the ids run, the mask blend and grid when masking, the u8
    conversions."""
    rows = [list(map(int, r)) for r in ids]
    k, n = len(rows), len(rows[0])
    ops = 0
    for r in rows:
        for fid in r:
            if 0 <= fid < len(filter_names):
                name = filter_names[fid]
                ops += branch_ops(name, fast, curve_steps) + (
                    MASK_BLEND_OPS if masked and name != 'VignetFilter'
                    else 0)
    pixels = h * w
    item = 1 if u8 else 4
    flops = ops * pixels + n * pixels * (
        (MASK_GRID_OPS if masked else 0) + (3 * U8_IO_OPS if u8 else 0))
    p = max_params + (6 if masked else 0)
    nbytes = 2 * n * pixels * 3 * item + k * n * 4 + k * n * p * 4
    return {'flops': int(flops), 'bytes': int(nbytes)}
