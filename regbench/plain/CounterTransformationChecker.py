"""Stop after ``maxIterationCount`` iterations with the max-iterations code
1 (upstream TransformationCheckersImpl.cpp Counter)."""


def init(T0, params, ctx):
    return 0


def check(state, T, params, ctx):
    count = state + 1
    stop = count >= int(params.get("maxIterationCount", 40))
    return count, stop, 1 if stop else 0
