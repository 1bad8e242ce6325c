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
