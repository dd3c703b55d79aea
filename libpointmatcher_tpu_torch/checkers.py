"""Transformation checkers: decide when the ICP loop stops (counterpart of
``libpointmatcher_tpu.checkers``; reference: PointMatcher.h:580-618,
TransformationCheckersImpl.{h,cpp}).

Each checker is ``(state, T, iteration) → (state, stop, code)`` on device
tensors, so the loop reads one flag per iteration. ``code`` is 0,
CODE_MAX_ITER (stop, flags maxNumIterationsReached), CODE_NAN_ERROR or
CODE_BOUND_ERROR (stop; the engine raises ``ConvergenceError``). ``T`` may
carry leading batch dimensions (``[B, d+1, d+1]``); the state, flag and
code then have them too, one per scan."""

from __future__ import annotations

import torch

from .registry import Param, Parametrizable, Registrar
from .utils import se3

__all__ = ["TransformationChecker", "TransformationCheckerRegistrar",
           "CounterTransformationChecker", "DifferentialTransformationChecker",
           "BoundTransformationChecker", "CODE_MAX_ITER", "CODE_NAN_ERROR",
           "CODE_BOUND_ERROR"]

TransformationCheckerRegistrar = Registrar("TransformationChecker")

CODE_MAX_ITER = 1
CODE_NAN_ERROR = 2
CODE_BOUND_ERROR = 3


def _code(flag: torch.Tensor, code: int) -> torch.Tensor:
    return torch.where(flag, code, 0).to(torch.int32)


class TransformationChecker(Parametrizable):
    """Interface (reference: PointMatcher.h:580-618)."""

    def init_state(self, T0: torch.Tensor):
        return ()

    def check(self, state, T: torch.Tensor, iteration: int):
        raise NotImplementedError


@TransformationCheckerRegistrar.register
class CounterTransformationChecker(TransformationChecker):
    """Stop after maxIterationCount iterations, flagging
    maxNumIterationsReached (reference: TransformationCheckersImpl.cpp:46-76)."""

    PARAMS = (
        Param("maxIterationCount", "maximum number of iterations", int, 40,
              min=0),
    )

    def init_state(self, T0):
        return torch.zeros(T0.shape[:-2], dtype=torch.int32, device=T0.device)

    def check(self, state, T, iteration):
        count = state + 1
        stop = count >= self.maxIterationCount
        return count, stop, _code(stop, CODE_MAX_ITER)


@TransformationCheckerRegistrar.register
class DifferentialTransformationChecker(TransformationChecker):
    """Converged when the mean |Δrot| and |Δtrans| over a sliding window of
    ``smoothLength`` steps fall below thresholds; NaN means divergence
    (reference: TransformationCheckersImpl.cpp:85-158).

    State is a fixed ring of the last smoothLength+1 rotations/translations
    (the reference keeps unbounded vectors but only reads the window)."""

    PARAMS = (
        Param("minDiffRotErr", "threshold for the mean windowed rotation "
              "delta [rad]", float, 0.001, min=0.0, max=6.2831854),
        Param("minDiffTransErr", "threshold for the mean windowed translation "
              "delta", float, 0.001, min=0.0),
        Param("smoothLength", "number of iterations in the smoothing window",
              int, 3, min=0, max=80),
    )

    def init_state(self, T0):
        d = T0.shape[-1] - 1
        b = T0.shape[:-2]
        w = max(int(self.smoothLength), 1)
        R_hist = T0[..., None, :d, :d].expand(*b, w + 1, d, d).clone()
        t_hist = T0[..., None, :d, d].expand(*b, w + 1, d).clone()
        # the history length is the same for every scan of a lockstep batch
        # that is still running, so it stays a host int
        return R_hist, t_hist, 1            # init() pushes T0

    def check(self, state, T, iteration):
        R_hist, t_hist, length = state
        d = T.shape[-1] - 1
        w = R_hist.shape[-3] - 1
        R_hist = torch.cat([R_hist[..., 1:, :, :], T[..., None, :d, :d]], dim=-3)
        t_hist = torch.cat([t_hist[..., 1:, :], T[..., None, :d, d]], dim=-2)
        length = length + 1
        ang = se3.rotation_angle_between(R_hist[..., 1:, :, :],
                                         R_hist[..., :-1, :, :])
        tr = torch.linalg.norm(t_hist[..., 1:, :] - t_hist[..., :-1, :], dim=-1)
        mean_rot = torch.sum(ang, dim=-1) / w
        mean_trans = torch.sum(tr, dim=-1) / w
        # the reference evaluates the rule only once the history is longer
        # than the window
        converged = (mean_rot < self.minDiffRotErr) & (mean_trans < self.minDiffTransErr)
        stop_ok = converged & (length > w)
        isnan = torch.isnan(mean_rot) | torch.isnan(mean_trans)
        return (R_hist, t_hist, length), stop_ok | isnan, _code(isnan, CODE_NAN_ERROR)


@TransformationCheckerRegistrar.register
class BoundTransformationChecker(TransformationChecker):
    """Diverged (ConvergenceError) when the transform drifts too far from its
    initial value (reference: TransformationCheckersImpl.cpp:167-225)."""

    PARAMS = (
        Param("maxRotationNorm", "maximum angle from the initial rotation "
              "[rad]", float, 1.0, min=0.0),
        Param("maxTranslationNorm", "maximum distance from the initial "
              "translation", float, 1.0, min=0.0),
    )

    def init_state(self, T0):
        d = T0.shape[-1] - 1
        return T0[..., :d, :d].clone(), T0[..., :d, d].clone()

    def check(self, state, T, iteration):
        R0, t0 = state
        d = T.shape[-1] - 1
        ang = se3.rotation_angle_between(T[..., :d, :d], R0)
        dist = torch.linalg.norm(T[..., :d, d] - t0, dim=-1)
        out = (ang > self.maxRotationNorm) | (dist > self.maxTranslationNorm)
        return state, out, _code(out, CODE_BOUND_ERROR)
