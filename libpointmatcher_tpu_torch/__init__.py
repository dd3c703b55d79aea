"""libpointmatcher_tpu_torch: the PyTorch / CUDA port of
``libpointmatcher_tpu`` for NVIDIA Hopper cards.

The same modules, registry names and engines as the JAX package, written
in PyTorch, with the dense k-NN kernels hand-written in CUDA
(``csrc/knn.cu``). Entry points run on the card unless given
``device="cpu"``; without a card they raise. Arithmetic is float32
throughout, with TF32 off: a reduced-precision product corrupts the 4x4
pose compositions of the loop.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .cloud import PointCloud  # noqa: E402
from .device import resolve_device  # noqa: E402
from .errors import (ConvergenceError, InvalidModuleType,  # noqa: E402
                     InvalidParameter)
from .icp import ICP, ICPSequence  # noqa: E402

__all__ = ["PointCloud", "ICP", "ICPSequence", "ConvergenceError",
           "InvalidModuleType", "InvalidParameter", "resolve_device"]
