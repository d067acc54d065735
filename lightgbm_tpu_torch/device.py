"""Device selection shared by the port's entry points.

Entry points run on the card: ``device=None`` means ``"cuda"``, and with no
card that raises instead of carrying on quietly on the CPU.  The CPU is
taken only when the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class NoDeviceError(RuntimeError):
    """No CUDA device is available and the caller did not ask for the CPU."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
