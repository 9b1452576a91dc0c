"""Device ms a batch of the proxy resize (``core/serving.py::proxy_resize``:
the uint8 -> float32 conversion and the antialiased interpolation),
averaged over the traced batches."""

from benchmark.lib.serve_layers import batch_parts


def read(ctx):
    parts = batch_parts(ctx)
    if not parts:
        return None
    return 1e3 * sum(p['resize'] for p in parts) / len(parts)
