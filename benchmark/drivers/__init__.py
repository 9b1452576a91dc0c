"""One module a kind of cell (``workloads/<cell>.json``'s ``driver``); each
has ``run(spec, seed, seconds, trace) -> Result``."""
