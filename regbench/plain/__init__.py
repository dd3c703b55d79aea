"""Plain modules of the reference, one file per module of the port's chain
YAML, named as the YAML names it (``RandomSamplingDataPointsFilter.py``).

``reference.py`` finds a module's file by that name. A module file holds
plain torch only and imports nothing of the program; its kind is set by the
function it defines:

- a data-points filter: ``filter(points, params, draw, ctx) -> dict`` with
  ``keep`` (bool [N]) and, where it adds them, ``normals`` [N, 3] and
  ``cond`` [N] (how well the normal is defined: the gap of the two smallest
  eigenvalues over the largest, 0 where the normal is not defined by the
  data, as at a tie in a neighbour set);
- a matcher: ``match(queries, reference, params, ctx) -> (d2, ids)``, the
  squared distance and row of each query's match (+inf, -1 for none);
- an outlier filter: ``weights(d2, params, ctx) -> w``;
- an error minimizer: ``step(p, q, n, w, params, ctx) -> T`` (4x4);
- a transformation checker: ``init(T0, params, ctx)`` and
  ``check(state, T, params, ctx) -> (state, stop, code)``.

A later configuration with a module not here adds its file.
"""
