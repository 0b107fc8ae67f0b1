"""Device policy of the port.

Entry points (``train_als``, the CLI) run on the GPU unless the caller asks
for the CPU.  Asking for CUDA where there is none raises: nothing falls back
to the CPU behind the caller's back.  On CUDA every float32 matrix product
stays full float32 (no TF32), the counterpart of the JAX package's
``precision="highest"`` pins (``cfk_tpu/ops/solve.py:30-51``).
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The torch device for ``device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was requested but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
