"""Device selection for the port's entry points.

Every entry point takes `device=` and runs on the card unless the caller
asks for the CPU. Without a CUDA device the default raises instead of
quietly running the plain CPU path.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepflow_tpu_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path"
        )
    return dev


_DEVICE_ERROR_MARKERS = ("CUDA", "CUBLAS", "cuDNN", "device-side assert")


def is_device_error(exc: BaseException) -> bool:
    """True when `exc`, or an exception it was raised from, came from the
    CUDA device: torch's accelerator and CUDA error types, or a runtime
    error whose text names CUDA (a kernel wrapper's failed launch, an
    out-of-memory). Such an error is sticky — the context is gone and
    every later call on it fails — so callers end instead of retrying."""
    types = tuple(t for t in (getattr(torch, "AcceleratorError", None),
                              getattr(torch.cuda, "CudaError", None),
                              getattr(torch.cuda, "OutOfMemoryError", None)) if t is not None)
    seen: set[int] = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, types):
            return True
        if isinstance(exc, RuntimeError) and any(m in str(exc) for m in _DEVICE_ERROR_MARKERS):
            return True
        exc = exc.__cause__ or exc.__context__
    return False
