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
from .errors import (ConfigurationError, ConvergenceError,  # noqa: E402
                     InvalidElement, InvalidField, InvalidModuleType,
                     InvalidParameter, PointMatcherError,
                     TransformationError)
from .matchers import Matcher, Matches, MatcherRegistrar  # noqa: E402
from .minimizers import ErrorMinimizer, ErrorMinimizerRegistrar  # noqa: E402
from .outlierfilters import OutlierFilter, OutlierFilterRegistrar  # noqa: E402
from .checkers import (TransformationChecker,  # noqa: E402
                       TransformationCheckerRegistrar)
from .transformations import (PureTranslation,  # noqa: E402
                              RigidTransformation, SimilarityTransformation,
                              TransformationRegistrar)
from .inspectors import Inspector, InspectorRegistrar  # noqa: E402
from .loggers import Logger, LoggerRegistrar, set_logger  # noqa: E402
from .filters import (DataPointsFilter,  # noqa: E402
                      DataPointsFilterRegistrar, apply_filter_chain)
from .icp import ICP, ICPChainBase, ICPSequence  # noqa: E402
from . import io  # noqa: E402

__all__ = ["PointCloud", "ICP", "ICPSequence", "ICPChainBase", "Matches", "io",
           "DataPointsFilterRegistrar", "MatcherRegistrar",
           "OutlierFilterRegistrar", "ErrorMinimizerRegistrar",
           "TransformationCheckerRegistrar", "TransformationRegistrar",
           "InspectorRegistrar", "LoggerRegistrar", "Logger", "set_logger",
           "RigidTransformation",
           "SimilarityTransformation", "PureTranslation", "ConfigurationError",
           "ConvergenceError", "InvalidElement", "InvalidField", "InvalidModuleType",
           "InvalidParameter", "PointMatcherError", "TransformationError",
           "resolve_device"]
