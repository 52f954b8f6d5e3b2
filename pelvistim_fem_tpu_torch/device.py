"""Where the port's entry points put their tensors.

Every entry point that builds tensors takes `device=`, default "cuda":
the port runs on the card unless the caller asks for the CPU (the CPU
tests pass device="cpu").  Entry points that take tensors follow their
device.  Asking for a CUDA device where there is none raises; nothing
falls back to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if it names CUDA and no CUDA
    device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA "
                           "device is available; pass device='cpu' to run "
                           "on the CPU")
    return dev
