"""What the port's applications share: the ``--device`` flag, the
conversions of a pose at an application's edge, and where the reference's
example data lies."""

from __future__ import annotations

import os

import numpy as np
import torch

#: libpointmatcher's example data (its ``examples/data``: the clouds, and
#: ``icp_data``'s YAML chains with their ``.ref_trans``), expected under
#: ``examples/data`` of this repository; the directory is not committed
#: yet, so the applications that read it take another path
REFERENCE_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "examples", "data")


def add_device_argument(parser) -> None:
    """``--device``: the card by default; ``cpu`` runs on the CPU. Without
    a card the default raises: an application never falls back."""
    parser.add_argument("--device", default="cuda",
                        help="device to run on: cuda (the default; raises "
                        "without a card) or cpu")


def host(T) -> np.ndarray:
    """A pose (or any array) as numpy, from a tensor on any device."""
    if isinstance(T, torch.Tensor):
        return T.detach().cpu().numpy()
    return np.asarray(T)


def device_pose(T, device) -> torch.Tensor:
    """A pose as a float32 tensor on ``device``."""
    if not isinstance(T, torch.Tensor):
        T = np.asarray(T, np.float32)
    return torch.as_tensor(T, dtype=torch.float32, device=device)
