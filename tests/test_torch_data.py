"""The port's data loaders (``gspn_tpu_torch.data``: the PLY reader, the
point-prep library and its NumPy version, ScanNet, ShapeNet and PartNet)
against the JAX package's (``gspn_tpu.data``) on the same files, written
here in the release layouts from a seed.

Everything is compared for equality: the loaders move and relabel values
and never compute with them (the RGB scaling and the object normalization
are the same NumPy expressions on both sides). The JAX side runs its NumPy
route (``gspn_tpu.data.native._lib`` patched to ``lambda: None``: its
library is not built here), so the port's side takes ``impl="plain"``
where a draw depends on the route; the port's library (``impl="native"``,
built with ``g++``) is held against its own plain route.
"""

import json
import pathlib
import shutil

import h5py
import numpy as np
import pytest

from gspn_tpu.data import native as jnative
from gspn_tpu.data import partnet as jpartnet
from gspn_tpu.data import ply as jply
from gspn_tpu.data import scannet as jscannet
from gspn_tpu.data import shapenet as jshapenet
from gspn_tpu_torch.data import native, partnet, ply, preprocess_scannet, scannet, shapenet

PLY_DTYPE = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("red", "u1"), ("green", "u1"), ("blue", "u1")])
LABELS = ("chair", "table", "sofa", "bed", "desk", "cabinet", "wall", "floor", "couch")
NEEDS_GXX = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the point-prep library is built with g++")


def write_scan(root, scene_id: str, rng, n: int = 2000, extent: float = 4.0,
               n_inst: int = 5, fmt: str = "binary") -> pathlib.Path:
    """A scan directory in the ScanNet release layout: a vertex PLY with
    RGB (and an empty face element), over-segments of 0.5 m cells in
    ``segs.json``, and ``n_inst`` labelled segment groups (nyu40 names, some
    outside the 18 benchmark classes) in ``aggregation.json``."""
    scan = pathlib.Path(root) / scene_id
    scan.mkdir(parents=True)
    xyz = np.concatenate([rng.uniform(0, extent, (n, 2)), rng.uniform(0, 2.5, (n, 1))],
                         1).astype(np.float32)
    arr = np.empty(n, PLY_DTYPE)
    arr["x"], arr["y"], arr["z"] = xyz.T
    for c in ("red", "green", "blue"):
        arr[c] = rng.integers(0, 256, n)
    header = (f"ply\nformat {'ascii' if fmt == 'ascii' else 'binary_little_endian'} 1.0\n"
              f"element vertex {n}\nproperty float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "element face 0\nproperty list uchar int vertex_indices\nend_header\n")
    with open(scan / f"{scene_id}_vh_clean_2.ply", "wb") as f:
        f.write(header.encode())
        if fmt == "ascii":
            f.write("".join(f"{x:.9g} {y:.9g} {z:.9g} {r} {g} {b}\n"
                            for x, y, z, r, g, b in arr.tolist()).encode())
        else:
            f.write(arr.tobytes())
    cell = (xyz[:, 0] // 0.5).astype(np.int64) * 1000 + (xyz[:, 1] // 0.5).astype(np.int64)
    seg = np.unique(cell, return_inverse=True)[1]
    (scan / f"{scene_id}_vh_clean_2.0.010000.segs.json").write_text(
        json.dumps({"segIndices": seg.tolist()}))
    picks = rng.permutation(seg.max() + 1)[: 2 * n_inst]
    groups = [{"label": LABELS[int(rng.integers(0, len(LABELS)))],
               "segments": picks[2 * i: 2 * i + 2].tolist()} for i in range(n_inst)]
    (scan / f"{scene_id}.aggregation.json").write_text(json.dumps({"segGroups": groups}))
    return scan


def write_scannet_dir(root, seed: int = 0, sizes=(3000, 700, 2500)) -> pathlib.Path:
    """Scans of ``sizes`` vertices preprocessed by both packages' code into
    ``root/npz`` (equal files, see ``test_preprocess_to_npz_cli_matches_jax``);
    the first and last scans are big enough to be block-cropped at 1024
    points a crop."""
    rng = np.random.default_rng(seed)
    root = pathlib.Path(root)
    for i, n in enumerate(sizes):
        write_scan(root / "scans", f"scene{i:04d}_00", rng, n=n)
    preprocess_scannet.main(["--scans", str(root / "scans"), "--out", str(root / "npz")])
    return root / "npz"


def write_shapenet_h5(path, rng, b: int = 20, n: int = 128, categories: int = 4):
    """``data (B, N, 3)`` and ``label (B,)``, as ``tests/test_h5_loaders.py``."""
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=rng.standard_normal((b, n, 3)).astype(np.float32) * 3)
        f.create_dataset("label", data=rng.integers(0, categories, b).astype(np.int64))


def write_partnet_h5(path, rng, b: int = 10, n: int = 96, keys=("pts", "label", "ins_label")):
    """Points, 0-based part classes and instance ids (-1 unassigned) under
    ``keys``, as ``tests/test_h5_loaders.py``."""
    with h5py.File(path, "w") as f:
        f.create_dataset(keys[0], data=rng.standard_normal((b, n, 3)).astype(np.float32))
        f.create_dataset(keys[1], data=rng.integers(0, 5, (b, n)).astype(np.int64))
        f.create_dataset(keys[2], data=rng.integers(-1, 6, (b, n)).astype(np.int64))


@pytest.fixture
def jax_plain(monkeypatch):
    """The JAX package's point prep on its NumPy route."""
    monkeypatch.setattr(jnative, "_lib", lambda: None)


def _assert_batches_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, list):
            assert got[k] == w, k
        else:
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


# ---------------------------------------------------------------------------
# ply.py, scannet.py's preprocessing, preprocess_scannet.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["binary", "ascii"])
def test_read_ply_vertices_matches_jax(tmp_path, fmt):
    scan = write_scan(tmp_path, "scene0000_00", np.random.default_rng(1), n=300, fmt=fmt)
    path = str(scan / "scene0000_00_vh_clean_2.ply")
    got, want = ply.read_ply_vertices(path), jply.read_ply_vertices(path)
    _assert_batches_equal(got, want)
    assert list(got) == ["x", "y", "z", "red", "green", "blue"] and len(got["x"]) == 300


def test_read_ply_refuses_what_it_cannot_read(tmp_path):
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply\n")
    with pytest.raises(ValueError, match="not a PLY file"):
        ply.read_ply_vertices(str(bad))
    bad.write_bytes(b"ply\nformat binary_big_endian 1.0\nelement vertex 0\nend_header\n")
    with pytest.raises(ValueError, match="unsupported PLY format"):
        ply.read_ply_vertices(str(bad))


def test_preprocess_scene_matches_jax(tmp_path):
    """RGB scaled to [0, 1], benchmark classes from the aggregation's nyu40
    names (a label TSV overriding the built-in map), one instance a
    benchmark-class group."""
    scan = write_scan(tmp_path, "scene0001_00", np.random.default_rng(2), n=800, n_inst=8)
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("id\traw_category\tnyu40id\n1\tchair\t5\n2\twall\t1\n3\ttable\t7\n"
                   "4\tcouch\t6\n5\tsofa\t\n")
    for label_map in (None, scannet.load_label_tsv(str(tsv))):
        got = scannet.preprocess_scene(scan, label_map)
        want = jscannet.preprocess_scene(scan, label_map)
        _assert_batches_equal(got, want)
    assert scannet.load_label_tsv(str(tsv)) == jscannet.load_label_tsv(str(tsv))
    assert got["inst_label"].max() > 1 and got["rgb"].max() <= 1.0


def test_preprocess_to_npz_cli_matches_jax(tmp_path, capsys):
    """``python -m gspn_tpu_torch.data.preprocess_scannet`` writes the npz the
    JAX package's ``preprocess_to_npz`` writes, and skips a scan directory
    missing a file with a line saying so."""
    rng = np.random.default_rng(3)
    for i in range(2):
        write_scan(tmp_path / "scans", f"scene{i:04d}_00", rng, n=400)
    (tmp_path / "scans" / "scene0009_00").mkdir()  # an incomplete scan
    written = preprocess_scannet.main(["--scans", str(tmp_path / "scans"),
                                       "--out", str(tmp_path / "port")])
    assert [p.name for p in written] == ["scene0000_00.npz", "scene0001_00.npz"]
    assert "scene0009_00: SKIP" in capsys.readouterr().out
    for p in written:
        want = jscannet.preprocess_to_npz(tmp_path / "scans" / p.stem, tmp_path / "jax")
        with np.load(p) as g, np.load(want) as w:
            _assert_batches_equal({k: g[k] for k in g.files}, {k: w[k] for k in w.files})


def test_preprocess_cli_refuses_an_empty_scans_dir(tmp_path):
    (tmp_path / "scans").mkdir()
    with pytest.raises(SystemExit, match="no scan directories"):
        preprocess_scannet.main(["--scans", str(tmp_path / "scans"), "--out", str(tmp_path)])


# ---------------------------------------------------------------------------
# ScanNetCrops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("morton", [False, True])
def test_scannet_crops_plain_route_match_jax(tmp_path, jax_plain, morton):
    """Block crops (scans above twice the crop size), whole-scene
    subsamples and padding (the small scan), RGB features, compacted ids and
    the ``scene_ids``: every array equal to the JAX loader's on its NumPy
    route, for the same generator."""
    npz = write_scannet_dir(tmp_path)
    got = scannet.ScanNetCrops(str(npz), num_points=1024, morton=morton, impl="plain")
    want = jscannet.ScanNetCrops(str(npz), num_points=1024, morton=morton)
    for seed in range(3):
        _assert_batches_equal(got.sample_batch(np.random.default_rng(seed), 4),
                              want.sample_batch(np.random.default_rng(seed), 4))
    batch = got.sample_batch(np.random.default_rng(7), 6)
    assert (~batch["valid"]).any() and batch["features"].shape == (6, 1024, 3)
    assert len(set(batch["scene_ids"])) > 1


@NEEDS_GXX
def test_scannet_crops_native_route(tmp_path):
    """On the library's route a crop holds the same kinds of arrays, its
    ids compacted by first appearance, Morton-sorted crops the unsorted
    crops' points in another order, and the same generator gives the same
    batch."""
    npz = write_scannet_dir(tmp_path)
    ds = scannet.ScanNetCrops(str(npz), num_points=1024)
    a, b = (ds.sample_batch(np.random.default_rng(5), 4) for _ in range(2))
    _assert_batches_equal(a, b)
    for inst in a["inst_label"]:
        ids = inst[inst > 0]
        first = ids[np.sort(np.unique(ids, return_index=True)[1])]
        np.testing.assert_array_equal(first, np.arange(1, len(first) + 1))
    sorted_ds = scannet.ScanNetCrops(str(npz), num_points=1024, morton=True)
    c = sorted_ds.sample_batch(np.random.default_rng(5), 4)
    assert c["scene_ids"] == a["scene_ids"]
    for i in range(4):
        v = a["valid"][i]
        assert v.sum() == c["valid"][i].sum()
        key = lambda x: x[np.lexsort(x.T)]  # noqa: E731
        np.testing.assert_array_equal(key(a["xyz"][i][v]), key(c["xyz"][i][c["valid"][i]]))


def test_scannet_crops_refuse_an_unknown_route_and_an_empty_dir(tmp_path):
    npz = write_scannet_dir(tmp_path, sizes=(100,))
    with pytest.raises(ValueError, match="auto|native|plain"):
        scannet.ScanNetCrops(str(npz), impl="numpy")
    with pytest.raises(FileNotFoundError, match="no .npz scenes"):
        scannet.ScanNetCrops(str(tmp_path / "scans"))


# ---------------------------------------------------------------------------
# native.py: the library against its plain route
# ---------------------------------------------------------------------------


def _both(fn, *args):
    return fn(*args, impl="native"), fn(*args, impl="plain")


@NEEDS_GXX
def test_block_crop_and_gather_pack_native_equal_plain():
    rng = np.random.default_rng(4)
    xyz = rng.uniform(0, 8, (5000, 3)).astype(np.float32)
    a, b = _both(native.block_crop_xy, xyz, 4.0, 3.5, 1.5)
    np.testing.assert_array_equal(a, b)
    assert 0 < len(a) < len(xyz) and a.dtype == np.int64
    feats = rng.uniform(size=(5000, 3)).astype(np.float32)
    sem = rng.integers(0, 19, 5000).astype(np.int32)
    inst = rng.integers(0, 9, 5000).astype(np.int32)
    for f in (feats, None):
        for k in (len(a) + 100, len(a) // 2):  # padded, and cut
            ga, gb = _both(native.gather_pack, xyz, f, sem, inst, a, k)
            for x, y in zip(ga, gb, strict=True):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


@NEEDS_GXX
@pytest.mark.parametrize("n_ids", [7, 4095, 5000])
def test_compact_instance_ids_native_equal_plain(n_ids):
    """Up to 4095 distinct ids in the library's table; above, it reports
    the overflow and the ids are mapped by the NumPy loop, the same
    result."""
    rng = np.random.default_rng(n_ids)
    ids = rng.permutation(np.arange(1, 20 * n_ids))[:n_ids]
    inst = np.concatenate([ids, rng.choice(ids, 3000), np.full(50, -1), np.zeros(50)])
    inst = rng.permutation(inst).astype(np.int32)
    (a, ka), (b, kb) = _both(native.compact_instance_ids, inst)
    np.testing.assert_array_equal(a, b)
    assert ka == kb == n_ids and a.max() == n_ids and (a[inst <= 0] == 0).all()
    jb, jk = jnative._compact_instance_ids_numpy(inst.copy())
    np.testing.assert_array_equal(a, jb)


@NEEDS_GXX
@pytest.mark.parametrize("n", [0, 1, 2, 600])
def test_morton_order_native_equal_plain_and_jax(jax_plain, n):
    """Bit for bit on both routes and against the JAX package's NumPy
    version, empty and single-point selections included; a permutation of
    the selection, spatially coherent."""
    rng = np.random.default_rng(n)
    xyz = rng.standard_normal((800, 3)).astype(np.float32)
    idx = rng.choice(800, n, replace=False).astype(np.int64)
    a, b = _both(native.morton_order, xyz, idx)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int64 and sorted(a.tolist()) == sorted(idx.tolist())
    np.testing.assert_array_equal(a, jnative.morton_order(xyz, idx))
    if n > 100:
        d_sorted = np.linalg.norm(np.diff(xyz[a], axis=0), axis=1).mean()
        assert d_sorted < 0.5 * np.linalg.norm(np.diff(xyz[idx], axis=0), axis=1).mean()


@NEEDS_GXX
def test_subsample_routes_draw_differently_but_deterministically():
    """The library's draw is its own (xorshift), the plain route's is
    ``Generator.choice``: each is a function of (indices, k, seed), and the
    two differ (the crop depends on the route)."""
    idx = np.arange(100, 5100, dtype=np.int64)
    a, b = _both(native.subsample, idx, 1000, 12345)
    np.testing.assert_array_equal(a, native.subsample(idx, 1000, 12345, impl="native"))
    np.testing.assert_array_equal(b, native.subsample(idx, 1000, 12345, impl="plain"))
    for x in (a, b):
        assert len(np.unique(x)) == 1000 and np.isin(x, idx).all()
    assert not np.array_equal(a, b)


def test_native_routes_refuse_an_unknown_impl():
    with pytest.raises(ValueError, match="auto|native|plain"):
        native.morton_order(np.zeros((1, 3), np.float32), np.zeros(1, np.int64), impl="numpy")


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source ``g++`` rejects, or no ``g++`` at all, raises: nothing falls
    back to NumPy."""
    bad = tmp_path / "pointprep.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    if shutil.which("g++") is not None:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.build()
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        native.build()
    assert not list(tmp_path.rglob("*.so"))


# ---------------------------------------------------------------------------
# morton_sort_batch
# ---------------------------------------------------------------------------


def _sortable_batch(rng, b=3, n=64):
    valid = rng.uniform(size=(b, n)) > 0.2
    return {"xyz": rng.standard_normal((b, n, 3)).astype(np.float32), "valid": valid,
            "features": rng.uniform(size=(b, n, 2)).astype(np.float32),
            "inst_label": rng.integers(0, 4, (b, n)).astype(np.int32),
            "sem_label": rng.integers(0, 4, (b, n)).astype(np.int32)}


@pytest.mark.parametrize("impl", ["plain", pytest.param("native", marks=NEEDS_GXX)])
def test_morton_sort_batch_matches_jax(jax_plain, impl):
    """Valid points z-ordered first, padding kept at the end, every listed
    per-point array co-sorted (an ``extra_per_point`` key too)."""
    rng = np.random.default_rng(8)
    batch = dict(_sortable_batch(rng), extra=rng.integers(0, 9, (3, 64)),
                 scene_ids=["a", "b", "c"])
    got = native.morton_sort_batch(batch, extra_per_point=("extra",), impl=impl)
    want = jnative.morton_sort_batch(batch, extra_per_point=("extra",))
    _assert_batches_equal(got, want)
    assert not got["valid"][:, -1].any() or got["valid"].all(axis=1).any()


def test_morton_sort_batch_allowlist_errors():
    """An unlisted key of per-point shape raises (pass it as
    ``extra_per_point`` or rename it), and so does a listed key that is not a
    ``(B, N, ...)`` array; a scene-level array is left alone."""
    rng = np.random.default_rng(9)
    batch = dict(_sortable_batch(rng), normals=rng.standard_normal((3, 64, 3)))
    with pytest.raises(ValueError, match="'normals' has per-point shape"):
        native.morton_sort_batch(batch, impl="plain")
    with pytest.raises(ValueError, match="per-point key 'sem_label' must be a"):
        native.morton_sort_batch(dict(_sortable_batch(rng), sem_label=np.zeros((3,))),
                                 impl="plain")
    with pytest.raises(ValueError, match="'normals' has per-point shape"):
        jnative.morton_sort_batch(batch)
    scene_level = dict(_sortable_batch(rng), num_instances=np.arange(3))
    out = native.morton_sort_batch(scene_level, impl="plain")
    assert out["num_instances"] is scene_level["num_instances"]


# ---------------------------------------------------------------------------
# ShapeNet and PartNet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_points,category", [(64, None), (128, 2), (200, None)])
def test_shapenet_objects_match_jax(tmp_path, num_points, category):
    """Rows streamed across two files (repeated draws in a batch), the
    category filter, the normalization, and columns sampled (fewer points
    than stored) or repeated (more): equal to the JAX loader's batches for
    one ``np.random.Generator`` seed."""
    rng = np.random.default_rng(10)
    write_shapenet_h5(tmp_path / "train0.h5", rng)
    write_shapenet_h5(tmp_path / "train1.h5", rng, b=7)
    got = shapenet.ShapeNetObjects(str(tmp_path), num_points=num_points, category=category)
    want = jshapenet.ShapeNetObjects(str(tmp_path), num_points=num_points, category=category)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.label, want.label)
    for seed in range(2):
        _assert_batches_equal(got.sample_batch(np.random.default_rng(seed), 12),
                              want.sample_batch(np.random.default_rng(seed), 12))
    with pytest.raises(ValueError, match="no objects"):
        shapenet.ShapeNetObjects(str(tmp_path), category=99)


@pytest.mark.parametrize("keys", [("pts", "label", "ins_label"),
                                  ("points", "sem_label", "inst_label")])
def test_partnet_parts_match_jax(tmp_path, keys):
    """Probed key names, rows streamed from two files, points sampled, and
    the 0-based part classes and instance ids shifted to 1.. (-1 to 0):
    equal to the JAX loader's batches for one seed."""
    rng = np.random.default_rng(11)
    write_partnet_h5(tmp_path / "p0.h5", rng, keys=keys)
    write_partnet_h5(tmp_path / "p1.h5", rng, b=4, keys=keys)
    for num_points in (48, 120):
        got = partnet.PartNetParts(str(tmp_path), num_points=num_points)
        want = jpartnet.PartNetParts(str(tmp_path), num_points=num_points)
        batch = got.sample_batch(np.random.default_rng(0), 6)
        _assert_batches_equal(batch, want.sample_batch(np.random.default_rng(0), 6))
    assert batch["inst_label"].min() >= 0 and (batch["sem_label"][batch["inst_label"] > 0] >= 1).all()


def test_partnet_refuses_unknown_keys(tmp_path):
    with h5py.File(tmp_path / "p.h5", "w") as f:
        f.create_dataset("xyz", data=np.zeros((1, 4, 3), np.float32))
    with pytest.raises(KeyError, match="none of"):
        partnet.PartNetParts(str(tmp_path))
