"""PyTorch/CUDA port of the anisotropic-cloth MPM simulator.

The package mirrors ``mpmavatar_tpu`` (the JAX reference) function by
function.  Plain tensor code is PyTorch; every Pallas kernel of the
reference becomes a hand-written CUDA kernel for Hopper (``sm_90a``) under
``ops/csrc``, launched through ``ops/_build.py``.  It imports neither JAX
nor the JAX package.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on CPU tensors each kernel wrapper runs its plain
PyTorch version, which is what the CPU tests hold against JAX.
"""

from __future__ import annotations

import torch

# The physics relies on true-f32 contractions (the JAX package pins the
# same, mpmavatar_tpu/__init__.py): no TF32 in matmuls or convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_device() -> torch.device:
    """The CUDA device; raises when there is none (never falls back to
    the CPU — a caller that wants the CPU passes ``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or the CUDA device when None."""
    return default_device() if device is None else torch.device(device)
