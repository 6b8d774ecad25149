"""Where the port runs: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card.  Without one this raises rather than
    falling back: a run on the CPU happens only when the caller passes
    ``device="cpu"`` (as the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default — pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def dtype_of(name) -> torch.dtype:
    """``"bfloat16"`` / ``torch.bfloat16`` -> ``torch.bfloat16``."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))
