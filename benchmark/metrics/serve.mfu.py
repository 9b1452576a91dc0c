"""The whole served batch's share of the card's float32 peak, in %: the
FLOPs of the traced batches (``reference/serve.py::serve_flops``: the
policy at every step counted by ``counts/flops.py`` on the
reference's own forward, the resize's taps; plus the chain's operations,
``counts/chain.py``, on the reference plan's ids) over the traced window's
seconds, divided by 67 TFLOP/s (the cells hold TF32 off)."""

from benchmark.counts.peaks import F32_FLOPS
from benchmark.lib.serve_layers import batch_parts, chain_counts, traced_ids
from benchmark.reference.serve import serve_flops


def read(ctx):
    trace = ctx.get('trace')
    if trace is None or not batch_parts(ctx):
        return None
    traffic = ctx['traffic']
    base = serve_flops(ctx['ref'], traffic['batch'], traffic['height'],
                       traffic['width'])
    flops = 0
    for ids in traced_ids(ctx):
        flops += base['policy'] + base['resize'] + \
            chain_counts(ctx, ids)['flops']
    return 100.0 * flops / trace.window_s / F32_FLOPS
