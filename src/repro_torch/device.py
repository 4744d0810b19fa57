"""Device resolution shared by every public entry point of the port."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present.  There is no silent fall back to the CPU: a
    caller that wants the CPU passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False;"
            f" pass device='cpu' to run the plain PyTorch path")
    return dev
