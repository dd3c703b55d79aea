"""Rigid transformation of a cloud (counterpart of
``libpointmatcher_tpu.transformations.RigidTransformation``; reference:
TransformationsImpl.cpp:50-151): points move, the directional descriptor
channels only rotate."""

from __future__ import annotations

import torch

from .cloud import PointCloud
from .registry import Parametrizable, Registrar
from .utils import se3

__all__ = ["Transformation", "RigidTransformation", "TransformationRegistrar"]

TransformationRegistrar = Registrar("Transformation")

_DIRECTIONAL = ("normals", "observationDirections")


class Transformation(Parametrizable):
    """Interface (reference: PointMatcher.h:404-421)."""

    def compute(self, cloud: PointCloud, T: torch.Tensor) -> PointCloud:
        raise NotImplementedError


@TransformationRegistrar.register
class RigidTransformation(Transformation):
    """SE(n) apply (reference: TransformationsImpl.cpp:50-87); ``T`` may
    carry the cloud's batch dimensions, one transform per scan."""

    def compute(self, cloud, T):
        d = cloud.dim
        R = T[..., :d, :d]
        descs = dict(cloud.descriptors)
        for name in _DIRECTIONAL:
            if name in descs and descs[name].shape[-1] == d:
                descs[name] = descs[name] @ R.mT
        return cloud.replace(points=se3.apply(T, cloud.points), descriptors=descs)
