"""Transformations: apply an SE(n)/Sim(n) matrix to a cloud, validate,
repair (counterpart of ``libpointmatcher_tpu.transformations``; reference:
PointMatcher.h:404-434, TransformationsImpl.{h,cpp}). Points move; the
directional descriptor channels (``normals``, ``observationDirections``)
and the ``eigVectors`` matrices only rotate. ``T`` may carry the cloud's
batch dimensions, one transform per scan."""

from __future__ import annotations

import torch

from .cloud import PointCloud
from .errors import TransformationError
from .registry import Parametrizable, Registrar
from .utils import se3

__all__ = ["Transformation", "RigidTransformation", "SimilarityTransformation",
           "PureTranslation", "TransformationRegistrar"]

TransformationRegistrar = Registrar("Transformation")

_DIRECTIONAL = ("normals", "observationDirections")


def _rotate_descriptors(descriptors, R: torch.Tensor):
    """Directions map to R·v (reference: TransformationsImpl.cpp:73-80);
    ``eigVectors`` rows are d×d row-major matrices whose columns are the
    eigenvectors (utils.h serializeEigVec), which map V → R·V."""
    d = R.shape[-1]
    out = dict(descriptors)
    for name in _DIRECTIONAL:
        if name in out and out[name].shape[-1] == d:
            out[name] = out[name] @ R.mT
    ev = out.get("eigVectors")
    if ev is not None and ev.shape[-1] == d * d:
        V = ev.reshape(*ev.shape[:-1], d, d)
        out["eigVectors"] = (R[..., None, :, :] @ V).reshape(ev.shape)
    return out


class Transformation(Parametrizable):
    """Interface (reference: PointMatcher.h:404-421)."""

    def compute(self, cloud: PointCloud, T: torch.Tensor) -> PointCloud:
        raise NotImplementedError

    def check_parameters(self, T: torch.Tensor) -> bool:
        return True

    def correct_parameters(self, T: torch.Tensor) -> torch.Tensor:
        return T


@TransformationRegistrar.register
class RigidTransformation(Transformation):
    """SE(n) apply with orthogonality validation
    (reference: TransformationsImpl.cpp:50-151)."""

    def compute(self, cloud, T):
        d = cloud.dim
        return cloud.replace(points=se3.apply(T, cloud.points),
                             descriptors=_rotate_descriptors(cloud.descriptors,
                                                             T[..., :d, :d]))

    def check_parameters(self, T) -> bool:
        """|det R − 1| ≤ 1e-3 for every transform of a batch (reference:
        TransformationsImpl.cpp:91-105)."""
        d = T.shape[-1] - 1
        det = torch.linalg.det(T[..., :d, :d])
        return bool(torch.all(torch.abs(det - 1.0) <= 1e-3))

    def compute_checked(self, cloud, T):
        if not self.check_parameters(T):
            raise TransformationError(
                "RigidTransformation: T does not represent a valid rigid "
                "transformation (|det R - 1| > 1e-3); use correct_parameters()")
        return self.compute(cloud, T)

    def correct_parameters(self, T):
        """Re-orthogonalize through the polar decomposition (the reference
        re-weaves with cross products, TransformationsImpl.cpp:109-151)."""
        return se3.orthogonalize(T)


@TransformationRegistrar.register
class SimilarityTransformation(Transformation):
    """Sim(n) apply: scale·R + t; no validity constraint
    (reference: TransformationsImpl.cpp:158-210)."""

    def compute(self, cloud, T):
        d = cloud.dim
        sR = T[..., :d, :d]
        # directions turn by the rotation part only
        scale = torch.linalg.det(sR) ** (1.0 / d)
        return cloud.replace(
            points=cloud.points @ sR.mT + T[..., None, :d, d],
            descriptors=_rotate_descriptors(cloud.descriptors,
                                            sR / scale[..., None, None]))


@TransformationRegistrar.register
class PureTranslation(Transformation):
    """Applies only the translation component
    (reference: TransformationsImpl.cpp:216-269)."""

    def compute(self, cloud, T):
        d = cloud.dim
        return cloud.replace(points=cloud.points + T[..., None, :d, d])

    def check_parameters(self, T) -> bool:
        d = T.shape[-1] - 1
        eye = torch.eye(d, dtype=T.dtype, device=T.device)
        return bool(torch.allclose(T[..., :d, :d], eye.expand_as(T[..., :d, :d]),
                                   atol=1e-6))

    def correct_parameters(self, T):
        d = T.shape[-1] - 1
        out = se3.identity(d, T.device).expand_as(T).clone()
        out[..., :d, d] = T[..., :d, d]
        return out
