"""enterprise_warp_tpu_torch — the PyTorch/CUDA port of enterprise_warp_tpu.

The JAX package ``enterprise_warp_tpu`` is the reference this package is
held against; nothing here imports it (or JAX). The port keeps the
reference's module names so each counterpart is easy to find, and runs
the reference's workflows: paramfile -> pulsar ingestion -> noise-model
lowering -> walker-batched marginalized likelihood of one pulsar or the
joint likelihood of an array (hand-written CUDA kernels,
``ops/csrc/megakernel.cu``) -> PT-MCMC, HMC or nested sampling -> the
reference's output-directory contract.

Conventions
-----------
- **Device.** Entry points take ``device=`` and default to ``"cuda"``;
  the CPU runs only when the caller asks for it. Asking for CUDA without
  a card raises (:func:`resolve_device`).
- **Dtypes.** Every tensor carries an explicit dtype: float64 for the
  host-precision islands (whitening, skinny Grams, equilibration, the
  timing-model Schur stage, sampler state), float32 for the kernel
  class. TF32 is off: the reference's in-kernel dots all run at
  ``Precision.HIGHEST``.
- **Randomness.** Explicit ``torch.Generator`` objects; the reference's
  threefry streams are not reproduced.
"""

__version__ = "0.1.0"

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
F32 = torch.float32


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. A CUDA request without a visible card raises instead of
    silently running on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host")
    return dev
