"""The benchmark of ``exposure_tpu_torch`` on NVIDIA GPUs (see README.md)."""
