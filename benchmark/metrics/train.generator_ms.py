"""ms an outer iteration of the generator and value phase alone
(``core/steps.py``'s ``g_update``: the bank rollout, the critic and value
passes, the two Adam updates, the pool's reinsertion): CUDA events around
replays of a fused runner built with ``(giters 1, citers 0)`` from the
window's state."""


def read(ctx):
    phases = ctx.get('phase_ms')
    return None if not phases else phases['generator']
