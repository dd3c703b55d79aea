"""Stop when the mean rotation and translation change over the last
``smoothLength`` iterations both lie under their thresholds, once the
history is longer than the window; a NaN stops with code 2 (upstream
TransformationCheckersImpl.cpp Differential). The history starts with the
loop's initial pose."""

import math

import torch


def _angle(Ra, Rb):
    # 2·asin(|Ra − Rb|_F / 2√2): the geodesic angle, exact near zero
    s = torch.linalg.norm(Ra - Rb) / (2.0 * math.sqrt(2.0))
    return 2.0 * math.asin(min(1.0, float(s)))


def init(T0, params, ctx):
    return [T0.clone()]


def _means(hist, w):
    last = hist[-(w + 1):]
    last = [hist[0]] * (w + 1 - len(last)) + last
    rot = sum(_angle(last[i + 1][:3, :3], last[i][:3, :3]) for i in range(w)) / w
    tr = sum(float(torch.linalg.norm(last[i + 1][:3, 3] - last[i][:3, 3]))
             for i in range(w)) / w
    return rot, tr


def check(state, T, params, ctx):
    w = max(int(params.get("smoothLength", 3)), 1)
    hist = state + [T.clone()]
    rot, tr = _means(hist, w)
    if math.isnan(rot) or math.isnan(tr):
        return hist, True, 2
    done = (rot < float(params.get("minDiffRotErr", 0.001))
            and tr < float(params.get("minDiffTransErr", 0.001))
            and len(hist) > w)
    return hist, done, 0
