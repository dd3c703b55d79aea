"""Keep each row whose draw lies under ``prob`` (upstream
DataPointsFilters/RandomSampling.cpp; the default reading filter)."""


def filter(points, params, draw, ctx):
    prob = float(params.get("prob", 0.75))
    return {"keep": draw.to(points.device) < prob}
