"""A frozen copy of ``exposure_tpu_torch``'s plain PyTorch modules (filter
bank, networks, agent step, losses, replay pool, Adam, device sampler and
the outer iteration), with their imports made relative.  The yardstick of
the benchmark: later changes to the program do not reach it."""
