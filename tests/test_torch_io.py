"""The port's IO layer (``libpointmatcher_tpu_torch.io``) against the JAX
package's on the CPU: CSV, VTK, PLY and PCD in ascii and binary, both ways
(files each package writes, read by the other), byte-equal saves, the
inline and malformed cases of ``tests/test_io.py``, int64 time channels,
the native and Python parse paths, the file lists and the native helpers.

Held exactly throughout: points, descriptors and times. Floats are written
as ``.9g``, which reads back to the same float32, and binary files hold the
float32 bits.
"""

import io as _io
import os
import struct

import numpy as np
import pytest
import torch

import libpointmatcher_tpu as pm
from libpointmatcher_tpu.io import filelist as jax_filelist

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.filters.sampling import covariance_greedy
from libpointmatcher_tpu_torch.io import native
from libpointmatcher_tpu_torch.io.csvio import load_csv
from libpointmatcher_tpu_torch.io.pcdio import load_pcd
from libpointmatcher_tpu_torch.io.plyio import load_ply
from libpointmatcher_tpu_torch.io.vtkio import load_vtk

CPU = "cpu"
#: (extension, binary) of every saved variant
VARIANTS = [("csv", False), ("vtk", False), ("vtk", True), ("ply", False),
            ("ply", True), ("pcd", False), ("pcd", True)]
STAMP0 = 1_700_000_000_123_456_789


def _arrays(n=400, seed=0):
    rng = np.random.default_rng(seed)
    pts = (10 * rng.standard_normal((n, 3))).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    descs = {"normals": nrm, "intensity": rng.random((n, 1)).astype(np.float32),
             "eigValues": rng.random((n, 3)).astype(np.float32)}
    times = {"time": STAMP0 + rng.integers(0, 2 ** 40, n)}
    return pts, descs, times


def _equal(cloud, pts, descs, times=None):
    p, d, t = cloud.to_numpy(with_times=True) if isinstance(
        cloud, pt.PointCloud) else cloud.to_numpy()
    np.testing.assert_array_equal(p, pts)
    assert list(d) == list(descs)
    for k, v in descs.items():
        np.testing.assert_array_equal(d[k], v, err_msg=k)
    if times is not None:
        assert list(t) == list(times)
        for k, v in times.items():
            np.testing.assert_array_equal(t[k][:, 0], v, err_msg=k)


@pytest.mark.parametrize("ext,binary", VARIANTS)
def test_round_trip_and_jax_both_ways(tmp_path, ext, binary):
    """The port's file reads back exactly in the port and in JAX, JAX's file
    in the port, and the two files are byte-equal."""
    pts, descs, _ = _arrays()
    mine, theirs = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    pt.io.save(pt.PointCloud.from_numpy(pts, descs, device=CPU), mine, binary=binary)
    pm.io.save(pm.PointCloud.from_numpy(pts, descs), theirs, binary=binary)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    _equal(pt.io.load(mine, device=CPU), pts, descs)
    _equal(pm.io.load(mine), pts, descs)
    _equal(pt.io.load(theirs, device=CPU), pts, descs)


@pytest.mark.parametrize("ext,binary", [v for v in VARIANTS if v[0] != "ply"])
def test_int64_times_exact(tmp_path, ext, binary):
    """Nanosecond stamps above 2^53 survive CSV, PCD (``I 8`` columns) and
    the VTK split-time pair exactly, in the port and read by JAX. The JAX
    writers lose them (ROADMAP Queue 3 #30-#32), so only the port's files
    are read both ways."""
    pts, descs, times = _arrays()
    path = str(tmp_path / f"t.{ext}")
    pt.io.save(pt.PointCloud.from_numpy(pts, descs, device=CPU, times=times), path,
               binary=binary)
    _equal(pt.io.load(path, device=CPU), pts, descs, times)
    _equal(pm.io.load(path), pts, descs, times)


def test_ply_carries_no_time(tmp_path):
    """PLY has no 64-bit integer type: the time channel is not written (as
    in the JAX package); points and descriptors still round-trip."""
    pts, descs, times = _arrays(n=50)
    path = str(tmp_path / "t.ply")
    pt.io.save(pt.PointCloud.from_numpy(pts, descs, device=CPU, times=times), path,
               binary=True)
    _equal(pt.io.load(path, device=CPU), pts, descs, {})


def test_vtk_2d_loads_3d(tmp_path):
    pts = np.random.default_rng(1).standard_normal((30, 2)).astype(np.float32)
    path = str(tmp_path / "flat.vtk")
    pt.io.save(pt.PointCloud.from_numpy(pts, device=CPU), path)
    c = pt.io.load(path, device=CPU)
    assert c.dim == 3
    np.testing.assert_array_equal(c.to_numpy()[0], np.c_[pts, np.zeros(30, np.float32)])


def test_loaders_default_to_the_card(tmp_path):
    """``device=None`` means the card: without one every loader raises."""
    path = str(tmp_path / "c.csv")
    pt.io.save(pt.PointCloud.from_numpy(np.zeros((3, 3)), device=CPU), path)
    if torch.cuda.is_available():
        assert pt.io.load(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.io.load(path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_csv(path)


# ------------------------------------------------------- inline and malformed
def _both(loader_t, loader_j, text):
    """The port's and JAX's loads of the same bytes (JAX's CSV loader reads
    text), held equal."""
    ct = loader_t(_io.BytesIO(text), device=CPU)
    cj = loader_j(_io.StringIO(text.decode()) if loader_t is load_csv
                  else _io.BytesIO(text))
    p, d, t = cj.to_numpy()
    _equal(ct, p, d, {k: v[:, 0] for k, v in t.items()})
    return ct


def test_inline_csv_header_variants():
    """tests/test_io.py::test_inline_csv_header_variants."""
    c = load_csv(_io.StringIO("x,y,z\n1,2,3\n4,5,6\n"), device=CPU)
    assert c.count_host() == 2 and c.dim == 3
    assert load_csv(_io.StringIO("x;y\n1;2\n3;4\n"), device=CPU).dim == 2
    c = load_csv(_io.StringIO("0.5 0.25\n0.75 0.125\n"), device=CPU)
    assert c.dim == 2 and c.count_host() == 2
    for head in ("x,y,z,nx,ny,nz", "x,y,z,normal_x,normal_y,normal_z"):
        c = _both(load_csv, pm.io.load_csv, f"{head}\n1,2,3,0,0,1\n".encode())
        assert c.has_descriptor("normals")
    c = _both(load_csv, pm.io.load_csv, b"1\t2\t3\t4\t5\n6\t7\t8\t9\t10\n")
    assert list(c.descriptors) == ["desc0", "desc1"]


def test_unknown_extension(tmp_path):
    with pytest.raises(RuntimeError):
        pt.io.load(str(tmp_path / "nonexistent.xyz"), device=CPU)
    path = str(tmp_path / "c.xyz")
    open(path, "w").write("1 2 3\n")
    with pytest.raises(RuntimeError, match="unknown extension"):
        pt.io.load(path, device=CPU)
    with pytest.raises(RuntimeError, match="unknown extension"):
        pt.io.save(pt.PointCloud.from_numpy(np.zeros((1, 3)), device=CPU), path)


PLY_ASCII = b"""ply
format ascii 1.0
comment hi
element vertex 3
property float x
property float y
property float z
property float nx
property float ny
property float nz
end_header
1 2 3 0 0 1
4 5 6 0 1 0
7 8 9 1 0 0
"""

PCD_ASCII = b"""# .PCD v.7 - Point Cloud Data file format
VERSION .7
FIELDS x y z
SIZE 4 4 4
TYPE F F F
COUNT 1 1 1
WIDTH 2
HEIGHT 1
VIEWPOINT 0 0 0 1 0 0 0
POINTS 2
DATA ascii
1 2 3
4 5 6
"""


def test_inline_ply_and_pcd():
    c = _both(load_ply, pm.io.plyio.load_ply, PLY_ASCII)
    assert c.count_host() == 3 and c.has_descriptor("normals")
    np.testing.assert_array_equal(c.to_numpy()[0], [[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    c = _both(load_pcd, pm.io.pcdio.load_pcd, PCD_ASCII)
    np.testing.assert_array_equal(c.to_numpy()[0], [[1, 2, 3], [4, 5, 6]])


def test_ply_binary_big_endian_with_faces():
    """Big-endian binary with a face element of list properties, which are
    skipped."""
    head = (b"ply\nformat binary_big_endian 1.0\nelement vertex 2\n"
            b"property double x\nproperty double y\nproperty double z\n"
            b"property uchar red\nelement face 1\n"
            b"property list uchar int vertex_indices\nend_header\n")
    body = struct.pack(">dddB", 1.5, 2.5, 3.5, 255) + struct.pack(">dddB", 4, 5, 6, 0)
    body += struct.pack(">Biii", 3, 0, 1, 0)
    c = _both(load_ply, pm.io.plyio.load_ply, head + body)
    np.testing.assert_array_equal(c.to_numpy()[1]["color"][:, 0], [255, 0])


def test_vtk_attribute_kinds():
    """An ascii UNSTRUCTURED_GRID with FIELD, SCALARS (two components),
    VECTORS, TENSORS and COLOR_SCALARS, and a binary one with COLOR_SCALARS
    as uchar / 255: the port's load equals JAX's."""
    ascii = b"""# vtk DataFile Version 3.0
t
ASCII
DATASET UNSTRUCTURED_GRID
POINTS 2 double
0.1 0.2 0.3 1 2 3
CELLS 2 4
1 0 1 1
CELL_TYPES 2
1 1
POINT_DATA 2
SCALARS pair float 2
LOOKUP_TABLE default
1 2 3 4
VECTORS v float
1 0 0 0 1 0
TENSORS tt float
1 2 3 4 5 6 7 8 9
9 8 7 6 5 4 3 2 1
COLOR_SCALARS color 3
0.5 0.25 1 0 0 1
FIELD FieldData 1
extra 2 2 float
5 6 7 8
"""
    c = _both(load_vtk, pm.io.load_vtk, ascii)
    assert list(c.descriptors) == ["pair", "v", "tt", "color", "extra"]
    binary = (b"# vtk DataFile Version 3.0\nt\nBINARY\nDATASET POLYDATA\n"
              b"POINTS 2 float\n" + np.array([1, 2, 3, 4, 5, 6], ">f4").tobytes()
              + b"\nCOLOR_SCALARS color 4\n"
              + np.array([0, 51, 102, 255, 255, 0, 0, 255], ">u1").tobytes() + b"\n")
    c = _both(load_vtk, pm.io.load_vtk, binary)
    np.testing.assert_array_equal(c.to_numpy()[1]["color"][0],
                                  np.array([0, 51, 102, 255], np.float32) / 255.0)


@pytest.mark.parametrize("loader,text", [
    (load_ply, b"not_a_ply\nformat ascii 1.0\nend_header\n"),
    (load_ply, b"ply\nformat ascii 1.0\nproperty float x\nend_header\n"),
    (load_ply, b"ply\nformat ascii 1.0\nelement vertex 0\n"),
    (load_pcd, b"VERSION .7\nPOINTS 1\nDATA ascii\n1 2 3\n"),
    (load_pcd, b"FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nPOINTS 1\nDATA zip\n"),
    (load_vtk, b"# vtk DataFile Version 3.0\nx\nASCII\nDATASET STRUCTURED_POINTS\n"),
    (load_vtk, b"# vtk DataFile Version 3.0\nx\nASCII\nDATASET POLYDATA\n"),
    (load_csv, b"a,b\n1,2\n"),
    (load_csv, b"\n\n"),
])
def test_malformed_rejected(loader, text):
    """tests/test_io.py's malformed cases, and a few more."""
    with pytest.raises(ValueError):
        loader(_io.BytesIO(text), device=CPU)


def test_save_load_dispatch_and_binary_flag(tmp_path):
    pts, descs, _ = _arrays(n=10)
    c = pt.PointCloud.from_numpy(pts, descs, device=CPU)
    for ext, binary in VARIANTS:
        p = str(tmp_path / f"b{int(binary)}.{ext}")
        pt.io.save(c, p, binary=binary)
        head = open(p, "rb").read(300)
        assert (b"BINARY" in head or b"binary" in head) == binary, (ext, head)
        assert pt.io.load(p, device=CPU).count_host() == 10


def test_pcd_binary_int64_time():
    """tests/test_io.py::test_pcd_binary_int64_time_roundtrip."""
    t = 1723880000123456789
    header = (b"VERSION .7\nFIELDS x y z time\nSIZE 4 4 4 8\n"
              b"TYPE F F F I\nCOUNT 1 1 1 1\nWIDTH 1\nHEIGHT 1\n"
              b"POINTS 1\nDATA binary\n")
    c = load_pcd(_io.BytesIO(header + struct.pack("<fffq", 1.0, 2.0, 3.0, t)),
                 device=CPU)
    assert c.get_time("time")[0, 0].item() == t


# ------------------------------------------------------------- native paths
def test_native_and_python_parsers_equal(tmp_path, monkeypatch):
    """The native tokenizer and Python's ``float`` are both correctly
    rounded: a CSV and an ascii VTK load give the same arrays on both
    paths, and ``parse_floats`` equals ``float`` bit for bit."""
    assert native.available()
    rng = np.random.default_rng(4)
    vals = np.concatenate([rng.standard_normal(500) * 10.0 ** rng.integers(-30, 30, 500),
                           [0.0, -0.0, 1e-310, 3.4e38, 0.1]])
    text = " ".join(repr(float(v)) for v in vals) + "\n" + ",".join(
        f"{v:.17e}" for v in vals[:50])
    want = np.array([float(t) for t in text.replace(",", " ").split()])
    assert np.array_equal(native.parse_floats(text.encode()).view(np.int64),
                          want.view(np.int64))
    pts, descs, _ = _arrays(n=300)
    c = pt.PointCloud.from_numpy(pts, descs, device=CPU)
    paths = {ext: str(tmp_path / f"c.{ext}") for ext in ("csv", "vtk")}
    for p in paths.values():
        pt.io.save(c, p)
    fast = {ext: pt.io.load(p, device=CPU) for ext, p in paths.items()}
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    for ext, p in paths.items():
        _equal(pt.io.load(p, device=CPU), *fast[ext].to_numpy())
        _equal(fast[ext], pts, descs)


def test_format_floats_equals_python():
    """``format_floats`` writes each row as Python's ``.9g`` does."""
    rng = np.random.default_rng(6)
    vals = (rng.standard_normal((200, 4)) * 10.0 ** rng.integers(-20, 20, (200, 4))
            ).astype(np.float32)
    want = "".join(" ".join(format(v, ".9g") for v in row) + "\n"
                   for row in vals.tolist())
    assert native.format_floats(vals) == want.encode()


def test_covariance_greedy_native_equals_numpy():
    """ROADMAP Queue 3 #25: the port's filter picks with the numpy
    transcription, which equals the compiled pick."""
    rng = np.random.default_rng(5)
    mag = rng.standard_normal((3000, 6)) * rng.uniform(0.1, 3, 6)
    mag[100:200] = mag[:100]          # ties
    for nb in (1, 50, 700, 3000):
        np.testing.assert_array_equal(native.covariance_greedy(mag, nb),
                                      covariance_greedy(mag, nb))


def test_native_baseline_register_conv():
    """tests/test_io.py::test_native_baseline_register_conv, through the
    port's bridge."""
    rng = np.random.default_rng(3)
    ref = rng.uniform(0, 10, (3000, 3))
    ref[:, 2] = 0.2 * np.sin(ref[:, 0]) + 0.1 * np.cos(ref[:, 1] * 2)
    nb = native.cpu_baseline(ref)
    assert nb is not None
    nb.compute_normals(10)
    ang = 0.02
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1.0]])
    t = np.array([0.05, -0.04, 0.02])
    src = (ref[::2] - t) @ R
    T, iters = nb.register_conv(src, max_iterations=40)
    assert 0 < iters <= 40
    np.testing.assert_allclose(T, nb.register(src, iters), rtol=0, atol=1e-12)
    np.testing.assert_allclose(T[:3, :3], R, atol=5e-3)
    np.testing.assert_allclose(T[:3, 3], t, atol=5e-3)


def test_file_info_vector_equals_jax(tmp_path):
    """A list with 4x4 initial and ground-truth transforms and gravity, one
    with 3x3 transforms, and one without ``reading`` (refused)."""
    rows4 = ["reading,reference,config," + ",".join(
        f"iT{i}{j}" for i in range(4) for j in range(4)) + "," + ",".join(
        f"gT{i}{j}" for i in range(4) for j in range(4)) + ",gx,gy,gz"]
    for k in range(3):
        T = np.eye(4)
        T[:3, 3] = [k, 0.5 * k, -k]
        rows4.append(f"r{k}.vtk,/abs/f{k}.vtk,c.yaml," + ",".join(
            repr(float(v)) for v in T.ravel()) * 1 + "," + ",".join(
            repr(float(v)) for v in (T * 2).ravel()) + f",0,0,{-9.8 + k}")
    rows3 = ["reading;iT00;iT01;iT02;iT10;iT11;iT12;iT20;iT21;iT22",
             "a.csv;1;0;0.5;0;1;0.25;0;0;1"]
    for name, rows, kw in (("l4.csv", rows4, {}), ("l3.csv", rows3,
                                                   {"data_path": "/data"})):
        path = str(tmp_path / name)
        open(path, "w").write("\n".join(rows) + "\n")
        got = pt.io.load_file_info_vector(path, **kw)
        want = jax_filelist.load_file_info_vector(path, **kw)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for f in ("reading", "reference", "configuration"):
                assert getattr(g, f) == getattr(w, f)
            for f in ("initial_transformation", "ground_truth_transformation",
                      "gravity"):
                a, b = getattr(g, f), getattr(w, f)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "bad.csv")
    open(path, "w").write("reference\nx.vtk\n")
    with pytest.raises(RuntimeError, match="reading"):
        pt.io.load_file_info_vector(path)
    assert isinstance(pt.io.load_file_info_vector(str(tmp_path / "l3.csv")),
                      pt.io.FileInfoVector)
    assert os.path.isabs(pt.io.load_file_info_vector(str(tmp_path / "l3.csv"))[0].reading)
