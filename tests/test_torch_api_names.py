"""The public names the port took from the JAX package's surface, each held
to the JAX function on the same inputs on the CPU: the cloud's channel
helpers and int64 layout converters, ``bucket_size``, the standalone filter
chain from YAML, ``Matcher.find_closests``, the pose-vector helpers of
``utils/se3.py`` and the package-level exports.

Tolerances: the pose helpers within 1e-6 (both packages evaluate the same
closed forms in float32); ``find_closests`` ids exactly and d² within 1e-6
relative (the dense search's difference form); the rest exactly.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpointmatcher_tpu as pm
from libpointmatcher_tpu import cloud as jcloud
from libpointmatcher_tpu import config as jconfig
from libpointmatcher_tpu.matchers import MatcherRegistrar as JMatchers
from libpointmatcher_tpu.utils import se3 as jse3

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch import cloud, config, filters, ops, utils
from libpointmatcher_tpu_torch.filters import DataPointsFilterRegistrar
from libpointmatcher_tpu_torch.matchers import (Matcher, MatcherRegistrar,
                                                has_host_tables)
from libpointmatcher_tpu_torch.utils import se3

CPU = "cpu"


def _clouds(n=50, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    descs = {"normals": rng.normal(size=(n, 3)).astype(np.float32),
             "intensity": rng.uniform(size=n).astype(np.float32)}
    stamps = rng.integers(0, 2**62, size=n, dtype=np.int64)
    j = pm.PointCloud.from_numpy(pts, descs)
    # the JAX cloud is padded to its bucket (Queue 3 #2): so is its channel
    j = j.with_time("stamp", np.pad(stamps, (0, j.num_points - n)))
    t = pt.PointCloud.from_numpy(pts, descs, device=CPU, times={"stamp": stamps})
    return j, t


def test_channel_labels_and_without_descriptor():
    j, t = _clouds()
    assert t.descriptor_labels() == j.descriptor_labels() == (
        ("normals", 3), ("intensity", 1))
    assert t.time_labels() == j.time_labels() == (("stamp", 1),)
    assert (t.without_descriptor("normals").descriptor_labels()
            == j.without_descriptor("normals").descriptor_labels())
    assert t.without_descriptor("absent").descriptor_labels() == t.descriptor_labels()


@pytest.mark.parametrize("n", [None, 7])
def test_create_similar_empty(n):
    j, t = _clouds()
    je, te = j.create_similar_empty(n), t.create_similar_empty(n)
    assert te.num_points == (t.num_points if n is None else n)
    assert je.num_points == (j.num_points if n is None else n)
    assert te.count_host() == 0 and not te.mask.any()
    assert te.descriptor_labels() == je.descriptor_labels()
    assert te.time_labels() == je.time_labels()
    assert te.get_time("stamp").dtype == torch.int64
    assert te.device == t.device


def test_int64_layout_converters_equal_jax():
    rng = np.random.default_rng(1)
    stamps = np.concatenate([rng.integers(-2**63, 2**63 - 1, size=(40, 2),
                                          dtype=np.int64),
                             np.array([[0, -1], [2**62, -2**62]], np.int64)])
    split = cloud.split_int64(stamps)
    np.testing.assert_array_equal(split, jcloud.split_int64(stamps))
    np.testing.assert_array_equal(cloud.merge_int64(split), stamps)
    np.testing.assert_array_equal(cloud.merge_int64(split),
                                  jcloud.merge_int64(split))


def test_bucket_size_equals_jax():
    for n in list(range(0, 3000, 7)) + [10**5, 4 * 10**5 + 1]:
        for granule in (256, 512):
            assert cloud.bucket_size(n, granule) == jcloud.bucket_size(n, granule)


CHAIN = [{"MinDistDataPointsFilter": {"minDist": "0.5"}},
         {"BoundingBoxDataPointsFilter": {"xMin": "-1", "xMax": "1",
                                          "removeInside": "0"}},
         "IdentityDataPointsFilter"]
CHAIN_TEXT = """\
- MinDistDataPointsFilter:
    minDist: 0.5
- BoundingBoxDataPointsFilter:
    xMin: -1
    xMax: 1
    removeInside: 0
- IdentityDataPointsFilter
"""


@pytest.mark.parametrize("form", ["list", "stream", "text", "path"])
def test_filters_from_yaml_equals_jax(form, tmp_path):
    path = tmp_path / "chain.yaml"
    path.write_text(CHAIN_TEXT)
    make = {"list": lambda: CHAIN, "stream": lambda: io.StringIO(CHAIN_TEXT),
            "text": lambda: CHAIN_TEXT, "path": lambda: str(path)}[form]
    jchain, tchain = jconfig.filters_from_yaml(make()), config.filters_from_yaml(make())
    assert [type(f).__name__ for f in tchain] == [type(f).__name__ for f in jchain]
    j, t = _clouds(200, 2)
    for jf, tf in zip(jchain, tchain):
        j, t = jf.filter(j), tf.filter(t)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask)[:t.num_points])
    np.testing.assert_array_equal(t.to_numpy()[0], j.to_numpy()[0])


def test_filters_from_yaml_refuses_a_mapping():
    with pytest.raises(pt.ConfigurationError):
        config.filters_from_yaml("matcher: KDTreeMatcher")


def test_create_from_spec():
    f = config.create_from_spec(DataPointsFilterRegistrar, CHAIN[0])
    assert type(f).__name__ == "MinDistDataPointsFilter" and f.minDist == 0.5
    m = config.create_from_spec(MatcherRegistrar, "KDTreeMatcher")
    assert type(m).__name__ == "KDTreeMatcher" and m.knn == 1


def test_find_closests_uses_the_reference_of_init():
    rng = np.random.default_rng(3)
    ref = rng.uniform(-2, 2, (400, 3)).astype(np.float32)
    rd = (ref[:150] + 0.01 * rng.standard_normal((150, 3))).astype(np.float32)
    jm = JMatchers.create("KDTreeMatcher", {"knn": "2"})
    tm = MatcherRegistrar.create("KDTreeMatcher", {"knn": "2"})
    with pytest.raises(RuntimeError):
        tm.find_closests(pt.PointCloud.from_numpy(rd, device=CPU))
    jm.init(pm.PointCloud.from_numpy(ref))
    tm.init(pt.PointCloud.from_numpy(ref, device=CPU))
    jmat = jm.find_closests(pm.PointCloud.from_numpy(rd))
    tmat = tm.find_closests(pt.PointCloud.from_numpy(rd, device=CPU))
    np.testing.assert_array_equal(tmat.ids.numpy(), np.asarray(jmat.ids)[:150])
    np.testing.assert_allclose(tmat.dists.numpy(), np.asarray(jmat.dists)[:150],
                               rtol=1e-6, atol=1e-9)


def test_matcher_serving_defaults():
    """The base class's serving hooks: the reference itself and no host
    tables; the matchers with host tables override the latter."""
    _, t = _clouds()
    null = MatcherRegistrar.create("NullMatcher")
    assert null.serving_reference(t) is t and null.prepare_loop_host(None, None) is None
    assert Matcher.serving_loop_aux(null, t) is False
    assert not has_host_tables(null)
    assert not has_host_tables(MatcherRegistrar.create("CellGridMatcher"))
    assert has_host_tables(MatcherRegistrar.create("KDTreeMatcher"))
    assert has_host_tables(MatcherRegistrar.create("BlockGridMatcher"))


def _pose(rng, dim):
    if dim == 2:
        return np.float32([rng.uniform(-3, 3), *rng.normal(size=2)])
    return np.concatenate([rng.normal(size=3) * 0.7, rng.normal(size=3)]
                          ).astype(np.float32)


@pytest.mark.parametrize("dim", [2, 3])
def test_pose_vectors_equal_jax(dim):
    rng = np.random.default_rng(4 + dim)
    vs = np.stack([_pose(rng, dim) for _ in range(6)])
    T = se3.vec_to_pose(torch.from_numpy(vs), dim)
    for i, v in enumerate(vs):
        Tj = np.asarray(jse3.vec_to_pose(jnp.asarray(v), dim))
        np.testing.assert_allclose(T[i].numpy(), Tj, atol=1e-6)
        np.testing.assert_allclose(se3.pose_to_vec(T[i]).numpy(),
                                   np.asarray(jse3.pose_to_vec(jnp.asarray(Tj))),
                                   atol=1e-6)
        np.testing.assert_array_equal(se3.rotation(torch.from_numpy(Tj)).numpy(),
                                      np.asarray(jse3.rotation(jnp.asarray(Tj))))
        np.testing.assert_array_equal(
            se3.translation(torch.from_numpy(Tj)).numpy(),
            np.asarray(jse3.translation(jnp.asarray(Tj))))
    # batched: each pose as alone
    np.testing.assert_allclose(se3.pose_to_vec(T).numpy(), vs, atol=2e-6)
    np.testing.assert_allclose(se3.compose(T[0], T[1]).numpy(),
                               np.asarray(jse3.compose(jnp.asarray(T[0].numpy()),
                                                       jnp.asarray(T[1].numpy()))),
                               atol=1e-6)


def test_normalize_angle_equals_jax():
    a = np.float32([0.0, 3.0, -3.0, 3.2, -3.2, 7.0, -12.5, np.pi, -np.pi, 100.0])
    np.testing.assert_allclose(se3.normalize_angle(torch.from_numpy(a)).numpy(),
                               np.asarray(jse3.normalize_angle(jnp.asarray(a))),
                               atol=1e-6)


def test_package_exports():
    """The JAX package's package-level names: ``ops.knn_brute_force``, the
    ``utils`` submodules and the four filter modules."""
    from libpointmatcher_tpu_torch.ops import knn

    assert ops.knn_brute_force is knn.knn_brute_force
    assert utils.se3.pose_to_vec is se3.pose_to_vec
    assert utils.masked.masked_quantile is not None
    assert {m.__name__.rsplit(".", 1)[1] for m in (
        filters.basic, filters.descriptor, filters.normals, filters.sampling)} == {
        "basic", "descriptor", "normals", "sampling"}
    assert cloud.bucket_size(300) == 384
