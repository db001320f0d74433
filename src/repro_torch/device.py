"""Device selection shared by every entry point of the port.

The port runs on the card: an entry point asked for no device uses
``cuda``, and raises when CUDA is absent instead of quietly falling back to
the CPU. Tests and CPU runs pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) "
            "to run the port on the CPU")
    return dev
