"""The harness's shared pieces: the command line's files and the run's
result (``common``), the measured window's arithmetic (``window``), the
profiler's trace (``trace``), seeded inputs and weights (``inputs``), and
what the serving cells' readers share (``serve_layers``)."""
