"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

A wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors — only because the tensors lie on the CPU; a CUDA tensor the kernel
cannot take raises.  Every wrapper counts its launches in ``<wrapper>.launches``
(a plain int, reset by the caller), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes

import torch


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if the (first) tensor lies on CUDA — the kernel route; False for
    the CPU — the plain route.  Any other device, or mixed devices, raise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on mixed devices: {dev} and {t.device}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev.type == "cuda"


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple[int, ...]) -> None:
    """Refuse what a kernel does not take: wrong dtype, shape or layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a C entry."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def scalar_on(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (a Python number or a 0-d/1-element tensor) as a 1-element tensor
    on ``device`` — kernels read per-chunk scalars from device memory, so the
    main path never syncs to the host for them.  A Python number is copied
    from the host, which a CUDA graph capture cannot hold: it is refused
    while the current stream captures (the captured half-steps pass device
    tensors)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(device=device, dtype=dtype)
    if torch.device(device).type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"scalar {x!r} would be copied from the host during a CUDA "
            "graph capture; pass it as a device tensor")
    return torch.tensor([x], device=device, dtype=dtype)
