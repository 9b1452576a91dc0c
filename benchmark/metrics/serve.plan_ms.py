"""Device ms a batch of the selected plan (``core/rollout.py::serve_rollout``:
``PolicyNet``'s convolutions and dense layers, the selection, K1 on the
proxies): every kernel of the batch but the resize, the full-resolution
replay and the input's and output's copies, averaged over the traced
batches."""

from benchmark.lib.serve_layers import batch_parts


def read(ctx):
    parts = batch_parts(ctx)
    if not parts:
        return None
    return 1e3 * sum(p['plan'] for p in parts) / len(parts)
