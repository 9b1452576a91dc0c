"""ms an outer iteration of the critic phase alone (``core/steps.py``'s
``c_update``: 5 WGAN-GP updates with the penalty's double backward, Adam,
the EMA): CUDA events around replays of a fused runner built with
``(giters 0, citers 5)`` from the window's state, as
``tools/bench_train_split.py`` splits the iteration."""


def read(ctx):
    phases = ctx.get('phase_ms')
    return None if not phases else phases['critic']
