"""Device resolution shared by every public entry point of the port."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``, a bare ``"cuda"`` made the current
    CUDA device (``cuda:0``), so that it compares equal to the device of
    the tensors created on it; raises when it names CUDA and no CUDA device
    is present.  There is no silent fall back to the CPU: a caller that
    wants the CPU passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False;"
            f" pass device='cpu' to run the plain PyTorch path")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor (a step's scalars) on ``device`` without waiting
    for the device: PyTorch's blocking host-to-device copy synchronizes the
    stream, which would stall the host once per copy.  From pageable
    memory the data is staged before the call returns, so the source may
    be freed at once."""
    return t.to(device, non_blocking=True)
