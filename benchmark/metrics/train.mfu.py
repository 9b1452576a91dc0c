"""The whole outer iteration's share of the card's float32 peak, in %: the
FLOPs of one iteration (``counts/flops.py`` over the reference's
own iteration at the cell's shapes: forward, backward and the gradient
penalty's double backward, convolutions and matmuls) over the traced
stretch's ms an iteration (the window's loop, ``depth`` short chunks),
divided by 67 TFLOP/s (TF32 off)."""

from benchmark.counts.peaks import F32_FLOPS


def read(ctx):
    if ctx.get('trace') is None or not ctx.get('iteration_flops'):
        return None
    return 100.0 * ctx['iteration_flops'] / (ctx['ms_per_iter'] / 1e3) \
        / F32_FLOPS
