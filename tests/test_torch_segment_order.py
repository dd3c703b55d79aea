"""The order of the segment sums behind VoxelGrid, OctreeGrid and
Elipsoids (``filters/sampling.py``): ``ordered_segment_sum``, the row-order
sum the card takes for segments of at most ``ORDERED_MAX_ROWS`` rows, equals
``index_add_`` on the CPU bit for bit, which adds each segment's rows in row
order, as the JAX package's ``segment_sum`` does. The card's side is in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from libpointmatcher_tpu_torch.filters import sampling


@pytest.mark.parametrize("shape", [(), (3,), (9,)])
@pytest.mark.parametrize("n,num", [(0, 4), (1, 1), (5000, 400), (20000, 9000),
                                   (3000, 40)])
def test_ordered_sum_equals_index_add(shape, n, num):
    rng = np.random.default_rng(n + num + len(shape))
    values = torch.from_numpy((rng.normal(size=(n,) + shape) * 10 + 5)
                              .astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, num, n))
    counts = torch.bincount(seg, minlength=num)
    got = sampling.ordered_segment_sum(values, seg, num, counts)
    want = torch.zeros((num,) + shape).index_add_(0, seg, values)
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(sampling.segment_sum(values, seg, num), want)


@pytest.mark.parametrize("num", [400, 40])
def test_a_plan_laid_out_as_the_card_lays_it_equals_index_add(num):
    """The card's path through ``segment_sum`` and ``segment_stats`` (a
    :func:`segment_plan` with a row-order layout, made once and shared by
    the sums), run here on CPU tensors, against ``index_add_``."""
    rng = np.random.default_rng(num)
    pts = torch.from_numpy((rng.normal(size=(5000, 3)) * 10 + 5).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, num, 5000))
    counts = torch.bincount(seg, minlength=num)
    plan = (counts, sampling._layout(seg, counts, int(counts.max())))
    assert sampling.segment_plan(seg, num)[1] is None       # the CPU's plan
    want = torch.zeros((num, 3)).index_add_(0, seg, pts)
    assert torch.equal(sampling.segment_sum(pts, seg, num, plan), want)
    for got, ref in zip(sampling.segment_stats(pts, seg, num, plan=plan),
                        sampling.segment_stats(pts, seg, num)):
        assert torch.equal(got, ref)
