"""Exact nearest neighbour (upstream MatchersImpl.h, libnabo with
epsilon 0), knn = 1, with ``maxDist`` when it is finite."""

from ._nn import nn1


def match(queries, reference, params, ctx):
    if int(params.get("knn", 1)) != 1 or float(params.get("epsilon", 0)) != 0:
        raise ValueError("the plain KDTreeMatcher serves knn = 1, epsilon = 0")
    return nn1(queries, reference, float(params.get("maxDist", "inf")), ctx)
