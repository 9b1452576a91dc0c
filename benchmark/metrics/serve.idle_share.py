"""The share of the traced serving window, in %, in which no kernel, copy
or fill ran on the card: one minus the union of the device's activity
intervals over the span from the first activity to the last."""


def read(ctx):
    trace = ctx.get('trace')
    if trace is None:
        return None
    return 100.0 * trace.idle_share()
