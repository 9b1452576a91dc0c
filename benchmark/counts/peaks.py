"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit).  A card set below 700 W runs slower under load, so
every run prints ``nvidia-smi``'s name and power limit on standard error
beside the numbers these peaks divide."""

F32_FLOPS = 67e12         # float32 outside the tensor cores
TF32_FLOPS = 495e12       # tensor cores, TF32
BF16_FLOPS = 989e12       # tensor cores, bf16 and fp16
HBM_BYTES = 3.35e12       # HBM3, bytes a second
HBM_CAPACITY = 80e9


def bound_s(flops, nbytes, flops_per_s=F32_FLOPS):
    """``(seconds, by)``: the least time for work of ``flops`` operations
    and ``nbytes`` bytes, and which of the two bounds it."""
    t_ops, t_bytes = flops / flops_per_s, nbytes / HBM_BYTES
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')
