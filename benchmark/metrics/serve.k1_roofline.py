"""The full-resolution K1 replay's share of its roofline, in %: the least
time the card could take (the larger of the chain's operations at 67
TFLOP/s and its bytes at 3.35 TB/s, ``counts/chain.py``, counted on the ids
the reference plan gives the traced batches) over the profiled time of the
uint8 ``dyn_chain_kernel`` launches, summed over the traced batches."""

from benchmark.counts.peaks import bound_s
from benchmark.lib.serve_layers import batch_parts, chain_counts, traced_ids


def read(ctx):
    parts = batch_parts(ctx)
    if not parts:
        return None
    spent = sum(p['k1'] for p in parts)
    if spent <= 0:
        return None
    need = 0.0
    for ids in traced_ids(ctx):
        c = chain_counts(ctx, ids)
        need += bound_s(c['flops'], c['bytes'])[0]
    return 100.0 * need / spent
