"""exposure_tpu_torch: the PyTorch/CUDA port of ``exposure_tpu``.

The module layout follows the JAX package so each counterpart is easy to
find (``exposure_tpu/ops/filters.py`` ->
``exposure_tpu_torch/ops/filters.py``).
This package imports ``torch`` and never ``jax`` or ``flax``; the JAX
package stays the reference the port is tested against.

Subpackages
-----------
- ``exposure_tpu_torch.utils``    numeric helpers and the config table.
- ``exposure_tpu_torch.ops``      filter bank, branchless chain, and the
  dynamic filter-chain kernel wrapper (CUDA on the GPU, plain PyTorch on
  the CPU).
- ``exposure_tpu_torch.kernels``  builds and binds the hand-written CUDA
  kernels under ``csrc/``.
- ``exposure_tpu_torch.models``   policy network and serving-side agent
  helpers.
- ``exposure_tpu_torch.core``     serving rollout, weight importer and the
  ``RetouchPipeline``; evaluation; training (steps, the streaming bundles,
  the ``Trainer``).
- ``exposure_tpu_torch.data``     the providers (FiveK, artist, folder,
  procedural, native packs), the folds and the device sampler.
- ``exposure_tpu_torch.native``   the C++ host loader, built by g++ at
  first use.
- ``exposure_tpu_torch.tools``    the kernel, evaluation and training tools.
"""

__version__ = "0.1.0"
