"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU with
``device="cpu"``. Without a card and without that request they raise: the
port never falls back to the CPU on its own."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "libpointmatcher_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the CPU")
    return dev
