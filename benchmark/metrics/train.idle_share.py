"""The share of the traced stretch, in %, in which no kernel, copy or
fill ran on the card (one minus the union of the device's activity
intervals over the stretch's span): ``depth`` short fused chunks
dispatched by the window's own loop, ``depth`` outstanding."""


def read(ctx):
    trace = ctx.get('trace')
    if trace is None:
        return None
    return 100.0 * trace.idle_share()
