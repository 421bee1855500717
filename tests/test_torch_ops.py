"""The PyTorch port's point ops (``gspn_tpu_torch.ops``, plain versions on
the CPU) against the JAX package's ops (``impl="xla"``, and the Pallas
kernels in interpret mode where the port has their counterpart) and the
NumPy oracles, on the same NumPy inputs. Integer outputs must be equal and
coordinates / distances bitwise equal, but for ``three_interpolate_mm``,
which sums in neighbor order where the JAX package's matmul kernel sums in
source order: 2e-6, the JAX package's own bound. Coordinates are often
snapped to a coarse grid so that equal distances (ties) actually occur."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gspn_tpu import ops as jops
from gspn_tpu.ops import ball_query as jquery
from gspn_tpu.ops import interpolate as jinterp
from gspn_tpu.ops import mask_project as jmask
from gspn_tpu.ops import nms as jnms
from gspn_tpu_torch import ops
from gspn_tpu_torch.ops import ball_query as tquery
from gspn_tpu_torch.ops import fps as tfps
from gspn_tpu_torch.ops import interpolate as tinterp
from gspn_tpu_torch.ops.ball_query import strided_target_mask
from tests import oracles
from tests.torch_parity import n, t


def _cloud(rng, b, npts, grid=False, pad=0.25):
    xyz = rng.uniform(0, 2, (b, npts, 3)).astype(np.float32)
    if grid:
        xyz = (np.round(xyz * 4) / 4).astype(np.float32)
    valid = np.ones((b, npts), bool)
    valid[:, npts - int(npts * pad):] = False
    valid[:, 0] = False  # the first valid point is not index 0
    return xyz, valid


def _mask(valid, masked):
    return valid if masked else None


def _tv(valid, masked):
    return t(valid) if masked else None


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fps_exact(rng, masked, grid):
    xyz, valid = _cloud(rng, 3, 64, grid=grid)
    got = n(ops.farthest_point_sample(16, t(xyz), _tv(valid, masked)))
    want = np.asarray(
        jops.farthest_point_sample(16, jnp.asarray(xyz), _mask(valid, masked), impl="xla")
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracles.fps_oracle(16, xyz, _mask(valid, masked)))
    assert got.dtype == np.int32


def test_fps_exact_beyond_one_block(rng):
    """Exact greedy FPS over 20,000 points, above one CUDA block's row
    (``FPS_MAX_N``; the card runs the cluster kernel there), with padding:
    the plain version's indices equal the JAX package's."""
    xyz, valid = _cloud(rng, 1, 20000, pad=0.1)
    assert 20000 > tfps.FPS_MAX_N
    got = n(ops.farthest_point_sample(64, t(xyz), t(valid)))
    want = np.asarray(jops.farthest_point_sample(64, jnp.asarray(xyz), valid, impl="xla"))
    np.testing.assert_array_equal(got, want)


def test_fps_cluster_size():
    """1 CTA up to one block's row, then 8 CTAs up to slices of 4096
    points, then 16 (the sizes measured fastest for both cluster kernels:
    4 x 16384 points fastest at 8, 1 x 65536 at 16, 2 x 14273 level at 8
    and 16); a legible refusal above 16 slices."""
    size = tfps.fps_cluster_size
    assert tfps.FPS_MAX_N == 14272
    assert [size(k) for k in (1, 8192, 14272)] == [1, 1, 1]
    assert [size(k) for k in (14273, 16384, 32768)] == [8, 8, 8]
    assert [size(k) for k in (32769, 65536, 131072, tfps.FPS_CLUSTER_MAX_N)] == [16] * 4
    for k in (14273, 32768, 32769, tfps.FPS_CLUSTER_MAX_N):
        assert -(-k // size(k)) <= tfps.FPS_MAX_N  # every slice fits one CTA
    with pytest.raises(ValueError, match=f"at most {tfps.FPS_CLUSTER_MAX_N} points"):
        size(tfps.FPS_CLUSTER_MAX_N + 1)


@pytest.mark.parametrize("nq,nscales,n", [
    (8192, 1, 8192), (512, 3, 8192), (2048, 1, 1024), (512, 1, 256), (128, 1, 64),
    (1024, 1, 65536), (64, 3, 65536), (512, 1, 8192), (64, 1, 65536), (256, 3, 4096),
    (1, 1, 1), (40, 4, 4096), (3, 2, 5000), (7, 2, 100), (30, 1, 131072),
])
def test_strided_plan(nq, nscales, n):
    """The strided groups' plan: direct (split 1) exactly up to
    STRIDED_DIRECT_POINTS points, else a power-of-two split in [1, 16] that
    keeps the launch within STRIDED_TARGET_WARPS warps (or is 1) and each
    warp's share of a tile at least a step; the ballots in shared memory
    exactly when a CTA's fit STRIDED_SMEM_BALLOTS, else a scratch of one
    word a 32 points (whole steps) a query and scale."""
    split, direct, ballots = tquery.strided_plan(nq, nscales, n, torch.device("cpu"))
    assert direct == (n <= tquery.STRIDED_DIRECT_POINTS)
    assert split in tquery.STRIDED_SPLITS and (split == 1 or not direct)
    assert split == 1 or (nq * split <= tquery.STRIDED_TARGET_WARPS
                          and tquery.STRIDED_TILE // split >= tquery.STRIDED_STEP)
    words = tquery.strided_words(n)
    assert words * 32 >= n and words % (tquery.STRIDED_STEP // 32) == 0
    assert words * 32 - n < tquery.STRIDED_STEP
    warps = tquery.STRIDED_DIRECT_WARPS if direct else tquery.STRIDED_CTA_WARPS
    fits = warps // split * nscales * words * 4 <= tquery.STRIDED_SMEM_BALLOTS
    assert (ballots is None) == fits
    if not fits:
        assert ballots.shape == (nq, nscales, words) and ballots.dtype == torch.int32
    with pytest.raises(ValueError, match="a strided plan"):
        tquery.strided_plan(nq, nscales, n, torch.device("cpu"), plan=(2, True))


def test_strided_plan_main_path_picks():
    """The plans measured fastest at slice (E)'s shapes (PERF.md): SA1,
    crops, SA2-SA4 and the boxes of the flagship (8 scenes x 8192 points)
    and of the whole scene (1 x 65536)."""
    split = tquery.strided_split
    assert [split(8 * 1024, 8192), split(8 * 64, 8192), split(8 * 256, 1024),
            split(8 * 64, 256), split(8 * 16, 64)] == [
        (1, False), (4, False), (1, True), (1, True), (1, True)]
    assert [split(1024, 65536), split(64, 65536), split(256, 1024), split(64, 256),
            split(16, 64)] == [(2, False), (16, False), (1, True), (1, True), (1, True)]


@pytest.mark.parametrize("mode", ["contiguous", "strided", "spatial"])
@pytest.mark.parametrize("masked", [False, True])
def test_fps_segmented(rng, mode, masked):
    xyz, valid = _cloud(rng, 2, 128, pad=0.6)  # trailing segments all-invalid
    got = n(ops.farthest_point_sample(
        32, t(xyz), _tv(valid, masked), segments=4, segment_mode=mode))
    want = np.asarray(jops.farthest_point_sample(
        32, jnp.asarray(xyz), _mask(valid, masked), impl="xla", segments=4,
        segment_mode=mode))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_spatial_sorted_view(rng, masked):
    xyz, valid = _cloud(rng, 2, 96, grid=True)  # equal codes: stability matters
    sxyz, svalid, sidx = ops.spatial_sorted_view(t(xyz), _tv(valid, masked))
    jx, jv, ji = jops.spatial_sorted_view(jnp.asarray(xyz), _mask(valid, masked))
    np.testing.assert_array_equal(n(sxyz), np.asarray(jx))
    np.testing.assert_array_equal(n(sidx), np.asarray(ji))
    if masked:
        np.testing.assert_array_equal(n(svalid), np.asarray(jv))
    else:
        assert svalid is None


@pytest.mark.parametrize("masked", [False, True])
def test_morton_codes_and_order(rng, masked):
    xyz, valid = _cloud(rng, 2, 96)
    got = n(ops.morton_codes(t(xyz), _tv(valid, masked)))
    np.testing.assert_array_equal(
        got, np.asarray(jops.morton_codes(jnp.asarray(xyz), _mask(valid, masked))))
    np.testing.assert_array_equal(
        n(ops.spatial_order(t(xyz), _tv(valid, masked))),
        np.asarray(jops.spatial_order(jnp.asarray(xyz), _mask(valid, masked))),
    )


@pytest.mark.parametrize("masked", [False, True])
def test_query_ball_group_multi(rng, masked):
    xyz, valid = _cloud(rng, 2, 128)
    q = np.concatenate(
        [xyz[:, :12], np.full((2, 1, 3), 50.0, np.float32)], axis=1)  # + an empty ball
    radii, ks = (0.3, 0.6), (8, 16)
    got = ops.query_ball_group_multi(radii, ks, t(xyz), t(q), _tv(valid, masked))
    want = jops.query_ball_group_multi(
        radii, ks, jnp.asarray(xyz), jnp.asarray(q), _mask(valid, masked), impl="xla")
    for (gi, gc, gl), (wi, wc, wl), r, k in zip(got, want, radii, ks, strict=True):
        np.testing.assert_array_equal(n(gi), np.asarray(wi))
        np.testing.assert_array_equal(n(gc), np.asarray(wc))
        np.testing.assert_array_equal(n(gl), np.asarray(wl))
        oi, oc = oracles.ball_query_oracle(r, k, xyz, q, _mask(valid, masked))
        np.testing.assert_array_equal(n(gi), oi)
        np.testing.assert_array_equal(n(gc), oc)
        want_local = np.take_along_axis(
            xyz, oi.reshape(2, -1, 1), axis=1).reshape(2, -1, k, 3) - q[:, :, None]
        np.testing.assert_array_equal(n(gl), want_local)
        assert gi.dtype == torch.int32 and gc.dtype == torch.int32


def _overflowing_balls(rng, b=2, npts=400):
    """A cloud, centres on it (balls of r 0.6 overflow K 16), and a
    centre with no point in reach."""
    xyz, valid = _cloud(rng, b, npts)
    q = np.concatenate([xyz[:, 1:10], np.full((b, 1, 3), 50.0, np.float32)], axis=1)
    return xyz, valid, q


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("select", ["first", "strided"])
@pytest.mark.parametrize("masked", [False, True])
def test_query_ball_point_multi(rng, masked, select, jax_impl):
    """Against JAX ``query_ball_point_multi`` (its XLA path, and the TPU's
    ``_ball_query_multi_kernel`` in interpret mode) and the oracle; strided
    differs from first-K where a ball holds more than K points."""
    xyz, valid, q = _overflowing_balls(rng)
    radii, ks = (0.3, 0.6), (8, 16)
    got = ops.query_ball_point_multi(radii, ks, t(xyz), t(q), _tv(valid, masked), select=select)
    want = jops.query_ball_point_multi(
        radii, ks, jnp.asarray(xyz), jnp.asarray(q), _mask(valid, masked), impl=jax_impl,
        select=select)
    first = ops.query_ball_point_multi(radii, ks, t(xyz), t(q), _tv(valid, masked))
    differs = False
    for (gi, gc), (wi, wc), (fi, _), r, k in zip(got, want, first, radii, ks, strict=True):
        np.testing.assert_array_equal(n(gi), np.asarray(wi))
        np.testing.assert_array_equal(n(gc), np.asarray(wc))
        oi, oc = oracles.ball_query_oracle(r, k, xyz, q, _mask(valid, masked), select=select)
        np.testing.assert_array_equal(n(gi), oi)
        np.testing.assert_array_equal(n(gc), oc)
        assert gi.dtype == torch.int32 and gc.dtype == torch.int32
        differs |= not torch.equal(gi, fi)
    assert differs == (select == "strided")


@pytest.mark.parametrize("select", ["first", "strided"])
@pytest.mark.parametrize("b,npts,radii,ks,m", [
    (2, 300, (0.25, 0.5, 1.0), (4, 8, 16), 6),  # the GSPN crops' three scales
    (2, 300, (0.1,), (8,), 40),  # SA1: one small ball a centre
    (3, 64, (0.8,), (8,), 5),  # a scene of one step (the direct plan's)
    (1, 129, (0.3, 0.6), (8, 24), 7),  # one point past the first step
])
def test_query_ball_point_multi_at_the_entry_points_shapes(rng, b, npts, radii, ks, m, select):
    """Small analogues of slice (F)'s ball queries: against the JAX op
    (its XLA path), and equal to the ball group's indices and counts."""
    xyz, valid = _cloud(rng, b, npts)
    q = np.concatenate([xyz[:, 1:m], np.full((b, 1, 3), 50.0, np.float32)], axis=1)
    got = ops.query_ball_point_multi(radii, ks, t(xyz), t(q), t(valid), select=select)
    want = jops.query_ball_point_multi(radii, ks, jnp.asarray(xyz), jnp.asarray(q), valid,
                                       impl="xla", select=select)
    grouped = ops.query_ball_group_multi(radii, ks, t(xyz), t(q), t(valid), select=select)
    for (gi, gc), (wi, wc), (fi, fc, _) in zip(got, want, grouped, strict=True):
        np.testing.assert_array_equal(n(gi), np.asarray(wi))
        np.testing.assert_array_equal(n(gc), np.asarray(wc))
        assert torch.equal(gi, fi) and torch.equal(gc, fc)


@pytest.mark.parametrize("select", ["first", "strided"])
@pytest.mark.parametrize("masked", [False, True])
def test_query_ball_point(rng, masked, select):
    xyz, valid, q = _overflowing_balls(rng)
    gi, gc = ops.query_ball_point(0.6, 8, t(xyz), t(q), _tv(valid, masked), select=select)
    wi, wc = jops.query_ball_point(0.6, 8, jnp.asarray(xyz), jnp.asarray(q),
                                   _mask(valid, masked), impl="xla", select=select)
    np.testing.assert_array_equal(n(gi), np.asarray(wi))
    np.testing.assert_array_equal(n(gc), np.asarray(wc))
    with pytest.raises(ValueError, match="must be"):
        ops.query_ball_point(0.6, 8, t(xyz[0]), t(q[0]))


def test_strided_target_mask(rng):
    """Rows with 0, fewer than, exactly and more than K hits (up to all N)."""
    hit = rng.random((3, 7, 200)) < np.linspace(0, 1, 7)[None, :, None]
    hit[0, 1, :5] = True
    for k in (1, 5, 16):
        got = n(strided_target_mask(t(hit), k))
        want = np.asarray(jquery._strided_target_mask(jnp.asarray(hit), k))
        np.testing.assert_array_equal(got, want)
        total = hit.sum(-1)
        np.testing.assert_array_equal(got.sum(-1), np.minimum(total, k))


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_query_ball_group_multi_strided(rng, masked, jax_impl):
    """Against JAX (its XLA path, and ``_fused_kernel_strided`` in interpret
    mode): indices and counts equal, local coordinates bitwise."""
    xyz, valid, q = _overflowing_balls(rng)
    radii, ks = (0.3, 0.6), (8, 16)
    got = ops.query_ball_group_multi(radii, ks, t(xyz), t(q), _tv(valid, masked),
                                     select="strided")
    want = jops.query_ball_group_multi(
        radii, ks, jnp.asarray(xyz), jnp.asarray(q), _mask(valid, masked), impl=jax_impl,
        select="strided")
    for g, w, r, k in zip(got, want, radii, ks, strict=True):
        for x, y in zip(g, w, strict=True):
            np.testing.assert_array_equal(n(x), np.asarray(y))
        oi, _ = oracles.ball_query_oracle(r, k, xyz, q, _mask(valid, masked), select="strided")
        np.testing.assert_array_equal(n(g[0]), oi)


def _box_oracle(boxes, s, xyz, valid):
    b, r, _ = boxes.shape
    idx = np.zeros((b, r, s), np.int32)
    cnt = np.zeros((b, r), np.int32)
    for bi in range(b):
        for ri in range(r):
            lo, hi = boxes[bi, ri, :3], boxes[bi, ri, 3:]
            hits = [
                j for j in range(xyz.shape[1])
                if (valid is None or valid[bi, j]) and np.all(xyz[bi, j] >= lo)
                and np.all(xyz[bi, j] <= hi)
            ][:s]
            cnt[bi, ri] = len(hits)
            if hits:
                idx[bi, ri, :] = hits[0]
                idx[bi, ri, : len(hits)] = hits
    return idx, cnt


@pytest.mark.parametrize("masked", [False, True])
def test_query_box_group(rng, masked):
    xyz, valid = _cloud(rng, 2, 128, grid=True)  # points on box faces: inclusive
    c = xyz[:, :10]
    half = (np.round(rng.uniform(0.1, 0.6, (2, 10, 3)) * 4) / 4).astype(np.float32)
    half[:, 0] = 0.0  # a degenerate box holding exactly the grid points at c
    boxes = np.concatenate([c - half, c + half], axis=-1)
    boxes[:, 1] = [9, 9, 9, 10, 10, 10]  # an empty box
    got = ops.query_box_group(t(boxes), 8, t(xyz), _tv(valid, masked))
    want = jops.query_box_group(
        jnp.asarray(boxes), 8, jnp.asarray(xyz), _mask(valid, masked), impl="xla")
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    oi, oc = _box_oracle(boxes, 8, xyz, _mask(valid, masked))
    np.testing.assert_array_equal(n(got[0]), oi)
    np.testing.assert_array_equal(n(got[1]), oc)


@pytest.mark.parametrize("case", ["empty", "fewer_than_s"])
def test_query_box_group_sparse_boxes(rng, case):
    """Boxes the first-S scan cannot fill, against JAX bitwise: empty boxes
    (index 0, count 0, point 0 minus the box centre) and boxes holding 1 to
    S - 1 points (the scan reads the whole scene; replicate-first padding)."""
    xyz, valid = _cloud(rng, 2, 96, grid=True)
    c = xyz[:, :6]
    if case == "empty":
        c = c + 50.0
    half = np.full((2, 6, 3), 0.25 if case == "fewer_than_s" else 0.5, np.float32)
    boxes = np.concatenate([c - half, c + half], axis=-1)
    got = ops.query_box_group(t(boxes), 8, t(xyz), t(valid))
    want = jops.query_box_group(jnp.asarray(boxes), 8, jnp.asarray(xyz), valid, impl="xla")
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    cnt = n(got[1])
    if case == "empty":
        assert not cnt.any() and not n(got[0]).any()
    else:
        assert (cnt < 8).all() and cnt.any()


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_query_box_group_strided(rng, masked, jax_impl):
    """Against JAX (its XLA path, and ``_fused_kernel_strided`` with
    ``pred="box"`` in interpret mode); boxes holding more than S points
    take other points than first-S."""
    xyz, valid = _cloud(rng, 2, 160, grid=True)
    c = xyz[:, :10]
    half = (np.round(rng.uniform(0.25, 0.75, (2, 10, 3)) * 4) / 4).astype(np.float32)
    boxes = np.concatenate([c - half, c + half], axis=-1)
    boxes[:, 1] = [9, 9, 9, 10, 10, 10]  # an empty box
    got = ops.query_box_group(t(boxes), 8, t(xyz), _tv(valid, masked), select="strided")
    want = jops.query_box_group(jnp.asarray(boxes), 8, jnp.asarray(xyz), _mask(valid, masked),
                                impl=jax_impl, select="strided")
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    first = ops.query_box_group(t(boxes), 8, t(xyz), _tv(valid, masked))
    assert not torch.equal(got[0], first[0])
    np.testing.assert_array_equal(n(got[1]), n(first[1]))


@pytest.mark.parametrize(
    "call",
    [
        lambda sel: ops.query_ball_point(0.1, 4, torch.zeros(1, 8, 3), torch.zeros(1, 2, 3),
                                         select=sel),
        lambda sel: ops.query_ball_point_multi(
            (0.1,), (4,), torch.zeros(1, 8, 3), torch.zeros(1, 2, 3), select=sel),
        lambda sel: ops.query_ball_group_multi(
            (0.1,), (4,), torch.zeros(1, 8, 3), torch.zeros(1, 2, 3), select=sel),
        lambda sel: ops.query_box_group(torch.zeros(1, 2, 6), 4, torch.zeros(1, 8, 3),
                                        select=sel),
    ],
    ids=["query_ball_point", "query_ball_point_multi", "ball_group", "box_group"],
)
def test_unknown_select_raises(call):
    with pytest.raises(ValueError, match="first|strided"):
        call("middle")


@pytest.mark.parametrize("masked", [False, True])
def test_three_nn(rng, masked):
    tgt, _ = _cloud(rng, 2, 96, grid=True)
    src, svalid = _cloud(rng, 2, 24, grid=True, pad=0.3)
    dist, idx = ops.three_nn(t(tgt), t(src), _tv(svalid, masked))
    jd, ji = jops.three_nn(
        jnp.asarray(tgt), jnp.asarray(src), _mask(svalid, masked), impl="xla")
    np.testing.assert_array_equal(n(dist), np.asarray(jd))
    np.testing.assert_array_equal(n(idx), np.asarray(ji))
    od, oi = oracles.three_nn_oracle(tgt, src, _mask(svalid, masked))
    np.testing.assert_array_equal(n(dist), od)
    np.testing.assert_array_equal(n(idx), oi)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_three_nn_beyond_2048_sources(rng, monkeypatch, masked, chunked):
    """M = 2304 is the TPU's tiled-M kernel (``_three_nn_tiled_kernel``):
    indices equal to it; distances bitwise equal to the XLA path and the
    oracle, and within 1e-6 of the kernel, which XLA's CPU interpret mode
    compiles with contracted multiply-adds. ``chunked``: the plain version
    over chunks of targets gives the same bits."""
    tgt, _ = _cloud(rng, 2, 40)
    src, svalid = _cloud(rng, 2, 2304, grid=True, pad=0.3)
    if chunked:
        monkeypatch.setattr(tinterp, "_PLAIN_PAIRS", 2 * 2304 * 7)  # 7 targets a chunk
    dist, idx = ops.three_nn(t(tgt), t(src), _tv(svalid, masked))
    args = (jnp.asarray(tgt), jnp.asarray(src), _mask(svalid, masked))
    pd, pi = jops.three_nn(*args, impl="pallas")
    xd, xi = jops.three_nn(*args, impl="xla")
    np.testing.assert_array_equal(n(idx), np.asarray(pi))
    np.testing.assert_array_equal(n(idx), np.asarray(xi))
    np.testing.assert_array_equal(n(dist), np.asarray(xd))
    np.testing.assert_allclose(n(dist), np.asarray(pd), rtol=1e-6)
    od, oi = oracles.three_nn_oracle(tgt, src, _mask(svalid, masked))
    np.testing.assert_array_equal(n(dist), od)
    np.testing.assert_array_equal(n(idx), oi)


def test_three_nn_fewer_than_three_valid_sources(rng):
    tgt, _ = _cloud(rng, 1, 16)
    src, _ = _cloud(rng, 1, 6)
    svalid = np.zeros((1, 6), bool)
    svalid[0, 4] = True
    dist, idx = ops.three_nn(t(tgt), t(src), t(svalid))
    jd, ji = jops.three_nn(jnp.asarray(tgt), jnp.asarray(src), svalid, impl="xla")
    np.testing.assert_array_equal(n(dist), np.asarray(jd))
    np.testing.assert_array_equal(n(idx), np.asarray(ji))


@pytest.mark.parametrize("b,n,m", [
    (8, 8192, 1024), (1, 65536, 1024), (8, 1024, 256), (8, 256, 64), (8, 64, 16),
    (512, 8192, 64), (8, 4096, 8192), (1, 4096, 65536), (1, 1, 3), (3, 100, 5000),
])
def test_three_nn_plan(b, n, m):
    """The kernel's (targets a thread, source slices, group): T in {1, 2,
    4}, S a power of 2 in [1, 32], a group of 1 or 32 sources that divides
    a slice's chunk of a tile, a slice keeps at least THREE_NN_MIN_SLICE
    sources when S > 1, and the kernel's layout of the sources over the
    slices (a tile of 2 sources a thread, each slice its own chunk of every
    tile) covers every source exactly once."""
    per, split, group = tinterp.three_nn_plan(b, n, m)
    assert per in (1, 2, 4)
    assert split in (1, 2, 4, 8, 16, 32)
    assert group in (1, 32)
    assert split == 1 or m // split >= tinterp.THREE_NN_MIN_SLICE
    q = min(max(8 // split, 1), -(-n // (32 * per)))  # target warps a CTA
    tile = 2 * 32 * q * split
    chunk = tile // split
    assert chunk % group == 0
    seen = np.zeros(m, int)
    for s in range(split):
        for base in range(0, m, tile):
            seen[base + s * chunk:min(base + (s + 1) * chunk, m)] += 1
    np.testing.assert_array_equal(seen, 1)


def test_three_nn_plan_main_path_picks():
    """The picks measured fastest at the main path's and the grid RoIs'
    shapes (PERF.md): FP4, FP3, FP2, 3nn masks, grid RoIs."""
    plan = tinterp.three_nn_plan
    assert [plan(8, 8192, 1024), plan(1, 65536, 1024), plan(8, 1024, 256), plan(8, 256, 64),
            plan(512, 8192, 64), plan(8, 4096, 8192), plan(1, 4096, 65536)] == [
        (1, 1, 32), (1, 1, 32), (1, 8, 1), (1, 2, 1), (4, 1, 1), (1, 4, 32), (1, 32, 32)]


# (sources, offset of each source's copy): the copy lands in another slice
# of the kernel's layout, or across a tile edge (512 or 1024 sources)
@pytest.mark.parametrize("m,offset", [(300, 150), (1100, 512), (2304, 1024), (700, 64)])
def test_three_nn_ties_across_slices_match_jax(rng, m, offset):
    """Sources repeated ``offset`` later (equal distances in two slices or
    tiles): the lower index first, as JAX's three_nn (its XLA route, and the
    TPU kernel in interpret mode) and the oracle give; with fewer than 3
    valid sources in one scene."""
    tgt, _ = _cloud(rng, 2, 40)
    src, svalid = _cloud(rng, 2, m, grid=True, pad=0.3)
    src[:, offset:] = src[:, :m - offset]
    svalid[1] = False
    svalid[1, [3, m - 2]] = True
    for valid in (None, svalid):
        dist, idx = ops.three_nn(t(tgt), t(src), None if valid is None else t(valid))
        args = (jnp.asarray(tgt), jnp.asarray(src), valid)
        xd, xi = jops.three_nn(*args, impl="xla")
        np.testing.assert_array_equal(n(idx), np.asarray(xi))
        np.testing.assert_array_equal(n(dist), np.asarray(xd))
        _, pi = jops.three_nn(*args, impl="pallas")
        np.testing.assert_array_equal(n(idx), np.asarray(pi))
        od, oi = oracles.three_nn_oracle(tgt, src, valid)
        np.testing.assert_array_equal(n(idx), oi)


def test_three_interpolate(rng):
    pts = rng.normal(size=(2, 24, 5)).astype(np.float32)
    dist = rng.uniform(0, 1, (2, 40, 3)).astype(np.float32)
    dist[0, 0] = 0.0  # clamped to eps
    idx = rng.integers(0, 24, (2, 40, 3)).astype(np.int32)
    w = ops.three_interpolate_weights(t(dist))
    jw = jops.three_interpolate_weights(jnp.asarray(dist))
    np.testing.assert_array_equal(n(w), np.asarray(jw))
    np.testing.assert_array_equal(
        n(ops.three_interpolate(t(pts), t(idx), w)),
        np.asarray(jops.three_interpolate(jnp.asarray(pts), jnp.asarray(idx), jw)),
    )


def _interp_case(rng, b, m, nt, c):
    pts = rng.standard_normal((b, m, c)).astype(np.float32)
    xyz1 = rng.uniform(0, 2, (b, nt, 3)).astype(np.float32)
    xyz2 = rng.uniform(0, 2, (b, m, 3)).astype(np.float32)
    dist, idx = jops.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2), impl="xla")
    return pts, np.asarray(idx), np.asarray(jops.three_interpolate_weights(dist))


@pytest.mark.parametrize("shape", [(2, 150, 200, 40), (1, jinterp._IMC + 300, 64, 8)],
                         ids=["small", "chunked_sources"])
def test_three_interpolate_mm_matches_jax(rng, shape):
    """Values within 2e-6 of JAX ``three_interpolate_mm`` (the TPU kernel in
    interpret mode), gradients within rtol 2e-5 / atol 2e-6."""
    pts, idx, w = _interp_case(rng, *shape)
    want = jops.three_interpolate_mm(jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(w))
    got = ops.three_interpolate_mm(t(pts), t(idx), t(w))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-6, atol=2e-6)

    def loss(p, ww):
        return jnp.sum(jnp.sin(jops.three_interpolate_mm(p, jnp.asarray(idx), ww)))

    jg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pts), jnp.asarray(w))
    tp = t(pts).requires_grad_(True)
    tw = t(w).requires_grad_(True)
    torch.sin(ops.three_interpolate_mm(tp, t(idx), tw)).sum().backward()
    for g, want_g in zip((tp.grad, tw.grad), jg, strict=True):
        np.testing.assert_allclose(n(g), np.asarray(want_g), rtol=2e-5, atol=2e-6)


def _interp_oracle(pts, idx, w):
    """Neighbor-ordered sum in NumPy float32: ``(p_0 w_0 + p_1 w_1) + p_2 w_2``."""
    g = np.take_along_axis(pts[:, None], idx[..., None].astype(np.int64), axis=2)  # (B,N,3,C)
    terms = (g * w[..., None]).astype(np.float32)
    return ((terms[:, :, 0] + terms[:, :, 1]) + terms[:, :, 2]).astype(np.float32)


def test_three_interpolate_mm_neighbor_order_and_repeats(rng):
    """The plain version is bitwise the neighbor-ordered sum and
    :func:`three_interpolate`, with sources picked two and three times."""
    pts = rng.standard_normal((2, 30, 6)).astype(np.float32)
    idx = rng.integers(0, 30, (2, 50, 3)).astype(np.int32)
    idx[:, :10, 1] = idx[:, :10, 0]  # a repeated source
    idx[:, 10:15, 2] = idx[:, 10:15, 0]
    idx[:, 15:20, 2] = idx[:, 15:20, 1]
    idx[:, 20:25, :] = idx[:, 20:25, :1]  # one source three times
    w = rng.uniform(0.01, 1, (2, 50, 3)).astype(np.float32)
    got = n(ops.three_interpolate_mm(t(pts), t(idx), t(w)))
    np.testing.assert_array_equal(got, _interp_oracle(pts, idx, w))
    np.testing.assert_array_equal(got, n(ops.three_interpolate(t(pts), t(idx), t(w))))


def test_three_interpolate_mm_large_source_block_equals_jax(rng):
    """Above the TPU kernel's 8 MB source block the JAX package takes the
    exact interpolation, which the port's neighbor-ordered sum equals."""
    pts, idx, w = _interp_case(rng, 1, 2100, 16, 1000)
    got = n(ops.three_interpolate_mm(t(pts), t(idx), t(w)))
    want = jops.three_interpolate_mm(jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(w))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        np.asarray(want), np.asarray(jops.three_interpolate(jnp.asarray(pts), jnp.asarray(idx),
                                                            jnp.asarray(w))))


def _fp_case(rng, b, m, nt, c2, c1):
    """Sources, three_nn's (squared) distances and indices from JAX's XLA
    path with a zero and a tiny distance (clamped to eps), and skip
    features or None."""
    pts = rng.standard_normal((b, m, c2)).astype(np.float32)
    xyz1 = rng.uniform(0, 2, (b, nt, 3)).astype(np.float32)
    xyz2 = rng.uniform(0, 2, (b, m, 3)).astype(np.float32)
    xyz1[0, 0] = xyz2[0, 5]  # distance 0
    xyz1[0, 1] = xyz2[0, 6] + np.float32(1e-6)  # a distance below eps
    dist, idx = jops.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2), impl="xla")
    skip = rng.standard_normal((b, nt, c1)).astype(np.float32) if c1 else None
    return pts, np.array(idx), np.array(dist), skip


@pytest.mark.parametrize("skip", [0, 12], ids=["no_skip", "skip"])
@pytest.mark.parametrize("shape", [(2, 150, 200, 40), (1, jinterp._IMC + 300, 64, 8)],
                         ids=["small", "chunked_sources"])
def test_three_interpolate_fp_matches_jax(rng, shape, skip):
    """The plain version is bitwise JAX ``three_interpolate(points, idx,
    three_interpolate_weights(dist))`` with ``jnp.concatenate`` of the skip
    (the exact interpolation), and within 2 ulp of the terms' magnitude of
    JAX ``three_interpolate_mm`` (the TPU kernel in interpret mode, which
    sums the three terms in source order)."""
    pts, idx, dist, p1 = _fp_case(rng, *shape, skip)
    got = n(ops.three_interpolate_fp(t(pts), t(idx), t(dist), None if p1 is None else t(p1)))
    jw = jops.three_interpolate_weights(jnp.asarray(dist))
    exact = np.asarray(jops.three_interpolate(jnp.asarray(pts), jnp.asarray(idx), jw))
    mm = np.asarray(jops.three_interpolate_mm(jnp.asarray(pts), jnp.asarray(idx), jw))
    want = exact if p1 is None else np.asarray(jnp.concatenate([exact, p1], axis=-1))
    np.testing.assert_array_equal(got, want)
    c2 = pts.shape[-1]
    g = np.take_along_axis(pts[:, None], idx[..., None].astype(np.int64), axis=2)
    mag = (np.abs(g) * np.asarray(jw)[..., None]).sum(axis=2, dtype=np.float32)
    assert (np.abs(got[..., :c2] - mm) <= 2 * np.spacing(mag)).all()


@pytest.mark.parametrize("skip", [0, 7], ids=["no_skip", "skip"])
@pytest.mark.parametrize("dist_grad", [False, True])
def test_three_interpolate_fp_gradients_equal_the_composite(rng, skip, dist_grad):
    """Its op's registered gradients in ``points2``, ``dist`` and
    ``points1`` on the CPU route are bitwise autograd's through the
    composite the FP module ran before (``three_interpolate_mm`` of
    ``three_interpolate_weights(dist)``, then the concat), sources picked
    several times."""
    pts, idx, dist, p1 = _fp_case(rng, 2, 30, 50, 6, skip)
    idx[:, :10, 1] = idx[:, :10, 0]  # a repeated source
    gout = rng.standard_normal((2, 50, 6 + skip)).astype(np.float32)

    def grads(fused):
        leaves = [t(pts).requires_grad_(True), t(dist).requires_grad_(dist_grad)]
        if p1 is not None:
            leaves.append(t(p1).requires_grad_(True))
        pp, dd, ss = leaves[0], leaves[1], (leaves[2] if p1 is not None else None)
        if fused:
            out = ops.three_interpolate_fp(pp, t(idx), dd, ss)
        else:
            out = ops.three_interpolate_mm(pp, t(idx), ops.three_interpolate_weights(dd))
            out = out if ss is None else torch.cat([out, ss], dim=-1)
        (torch.sin(out) * t(gout)).sum().backward()
        return out, [x.grad for x in leaves]

    (out, got), (ref, want) = grads(True), grads(False)
    assert torch.equal(out, ref)
    for g, w in zip(got, want, strict=True):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)
    assert (got[1] is not None) == dist_grad


@pytest.mark.parametrize("skip", [0, 7], ids=["no_skip", "skip"])
def test_three_interpolate_fp_gradient_without_points2(rng, monkeypatch, skip):
    """With ``points2`` needing no gradient the backward builds no source
    gradient (no scatter-add), and the gradients in ``dist`` and
    ``points1`` are still bitwise the composite's."""
    pts, idx, dist, p1 = _fp_case(rng, 2, 30, 50, 6, skip)
    gout = t(rng.standard_normal((2, 50, 6 + skip)).astype(np.float32))

    def grads(fused):
        dd = t(dist).requires_grad_(True)
        ss = None if p1 is None else t(p1).requires_grad_(True)
        if fused:
            out = ops.three_interpolate_fp(t(pts), t(idx), dd, ss)
        else:
            out = ops.three_interpolate_mm(t(pts), t(idx), ops.three_interpolate_weights(dd))
            out = out if ss is None else torch.cat([out, ss], dim=-1)
        (torch.sin(out) * gout).sum().backward()
        return [dd.grad] + ([] if ss is None else [ss.grad])

    want = grads(False)

    def no_scatter(*args, **kwargs):
        raise AssertionError("index_add_rows called for a points2 needing no gradient")

    monkeypatch.setattr(tinterp, "index_add_rows", no_scatter)
    for g, w in zip(grads(True), want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,n,m,c,c1", [
    (8, 64, 16, 512, 256), (8, 256, 64, 256, 128), (8, 1024, 256, 256, 64),  # FP1-FP3
    (8, 8192, 1024, 128, 0), (1, 65536, 1024, 128, 0),  # FP4, both scenes
    (1, 64, 16, 512, 256), (1, 5, 3, 5, 0), (3, 1000, 7, 1000, 0),
    (2, 10**5, 4096, 128, 0),  # sources beyond a CTA's shared memory
    (1, 10**6, 8, 64, 0), (4, 8192, 1024, 130, 0)])
def test_interp_mm_plan(b, n, m, c, c1):
    """Staged only without skip rows, with C a multiple of 32 and many rows
    a scene, within the kernel's chunk and a CTA's shared memory, a CTA an
    SM at most; otherwise rows a task within the kernel's 1-8 and slices of
    whole 128-float chunks, none beyond the row, grouping rows only where
    slicing is not needed."""
    rows, slices, stage = tinterp.interp_mm_plan(b, n, m, c, c1)
    if stage:
        assert stage == tinterp.INTERP_MM_STAGE and c1 == 0 and c % stage == 0
        assert slices == c // stage and 1 <= rows <= tinterp.INTERP_MM_MAX_CHUNK
        assert m * stage * 4 + rows * 32 <= tinterp.INTERP_MM_SMEM
        chunks = -(-n // rows)
        assert b * slices * chunks <= tinterp.INTERP_MM_SMS or rows == tinterp.INTERP_MM_MAX_CHUNK
        return
    assert 1 <= rows <= tinterp.INTERP_MM_MAX_ROWS
    assert 1 <= slices <= -(-(c + c1) // tinterp.INTERP_MM_SLICE)
    assert rows == 1 or slices == 1
    assert tinterp.interp_mm_plan(b, n, m, c, c1, aligned=False)[2] == 0


def test_interp_mm_plan_main_path_picks():
    """FP4 staged (4 slices of 32 channels; 4 chunks of 2048 rows at the
    flagship, 33 at the whole scene: 128 and 132 CTAs); FP1-FP3, with
    their skip rows, direct, at the plans timed fastest or within 0.0001
    ms of it on an H100 (FP1 in 4 slices, FP2 whole rows, FP3 4 rows a
    task; the whole scene's in 6, 3 and 2 slices)."""
    plan = tinterp.interp_mm_plan
    assert plan(8, 8192, 1024, 128) == (2048, 4, 32)
    assert plan(1, 65536, 1024, 128) == (1986, 4, 32)
    assert plan(8, 64, 16, 512, 256) == (1, 4, 0)
    assert plan(8, 256, 64, 256, 128) == (1, 1, 0)
    assert plan(8, 1024, 256, 256, 64) == (4, 1, 0)
    assert plan(1, 64, 16, 512, 256) == (1, 6, 0)
    assert plan(1, 256, 64, 256, 128) == (1, 3, 0)
    assert plan(1, 1024, 256, 256, 64) == (1, 2, 0)


def _proj_case(rng, b=2, npts=300, r=10, s=6, masked=True):
    """Points and samples on a coarse grid (equal distances), duplicate
    sample coordinates with different logits (the tie rule), a RoI whose
    samples are all invalid, and boxes about the first sample."""
    xyz = (np.round(rng.standard_normal((b, npts, 3)) * 2) / 2).astype(np.float32)
    samp = (np.round(rng.standard_normal((b, r, s, 3)) * 2) / 2).astype(np.float32)
    samp[:, :, 1] = samp[:, :, 0]
    logits = rng.standard_normal((b, r, s)).astype(np.float32)
    svalid = rng.random((b, r, s)) > 0.3 if masked else np.ones((b, r, s), bool)
    if masked:
        svalid[:, 0] = False
    pvalid = rng.random((b, npts)) > 0.15 if masked else np.ones((b, npts), bool)
    half = rng.uniform(0.2, 1.0, (b, r, 3)).astype(np.float32)
    boxes = np.concatenate([samp[:, :, 0] - half, samp[:, :, 0] + half], -1)
    return xyz, samp, logits, svalid, pvalid, boxes


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_nearest_sample_logit(rng, impl, masked):
    xyz, samp, logits, svalid, _, _ = _proj_case(rng, masked=masked)
    got = n(ops.nearest_sample_logit(t(xyz), t(samp), t(logits), _tv(svalid, masked)))
    want = jops.nearest_sample_logit(
        jnp.asarray(xyz), jnp.asarray(samp), jnp.asarray(logits), _mask(svalid, masked),
        impl=impl)
    np.testing.assert_array_equal(got, np.asarray(want))
    if masked:
        assert (got[:, 0] == -1e10).all()  # no valid sample


# sample offsets from the origin at a squared distance below, exactly at
# and above float32(3e10), every product and sum exact: 64 x (a, b, c) with
# a^2 + b^2 + c^2 = 7324218, 7324219 and 7324221
_FAR = np.array([[173120, 4288, 3328], [172992, 8256, 2368], [173056, 6848, 2176]],
                np.float32)


def _contract_case(rng, case):
    """``(xyz, samp, logits, svalid, want at scene point 0)``. "beyond_3e10":
    RoI q holds an invalid sample and valid ones, the nearest to point 0 (the
    origin) below, at and beyond 3e10 (q = 0, 1, 2), the others farther;
    points at multiples of 64 keep every distance to that nearest exact. "ties": samples at
    equal distances from point 0 (the six face neighbours at 0.5, one
    repeated) with different logits, and an invalid copy with the largest."""
    xyz = np.zeros((1, 8, 3), np.float32)
    xyz[0, 1:, 0] = np.arange(1, 8) * 64.0
    logits = rng.standard_normal((1, 3, 8)).astype(np.float32)
    svalid = np.ones((1, 3, 8), bool)
    if case == "beyond_3e10":
        samp = np.tile(_FAR[:, None] + np.float32(1.8e5) * np.eye(3, dtype=np.float32)[0],
                       (1, 1, 8, 1)).reshape(1, 3, 8, 3)
        samp[0, :, 2:] += np.arange(6, dtype=np.float32)[:, None] * 64.0
        samp[0, :, 1] = _FAR
        svalid[0, :, 0] = False
        want = np.array([logits[0, 0, 1], logits[0, 1, 1], -1e10], np.float32)
        return xyz, samp, logits, svalid, want
    face = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32) * 0.5
    samp = np.tile(face[None, None, [0, 1, 2, 3, 4, 5, 0, 3]], (1, 3, 1, 1))
    logits[0, :, 7] = 5.0  # the repeat of sample 3, invalid in RoI 0
    svalid[0, 0, 7] = False
    want = np.array([logits[0, 0, :7].max(), 5.0, 5.0], np.float32)
    return xyz, samp, logits, svalid, want


@pytest.mark.parametrize("case", ["beyond_3e10", "ties"])
def test_nearest_sample_logit_contract(rng, case):
    """The contract the card kernel keeps bitwise, against JAX: an invalid
    sample sits at exactly 3e10 (a valid one there ties with it and gives
    its logit, one beyond gives -1e10); on equal distances the largest
    valid logit wins."""
    xyz, samp, logits, svalid, want = _contract_case(rng, case)
    got = n(ops.nearest_sample_logit(t(xyz), t(samp), t(logits), t(svalid)))
    jgot = jops.nearest_sample_logit(jnp.asarray(xyz), jnp.asarray(samp), jnp.asarray(logits),
                                     jnp.asarray(svalid), impl="xla")
    np.testing.assert_array_equal(got, np.asarray(jgot))
    np.testing.assert_array_equal(got[0, :, 0], want)


@pytest.mark.parametrize("layout", ["random", "sorted"])
@pytest.mark.parametrize(
    "tiling", [dict(roi_block=8, tile_n=128), {}], ids=["rb8_tn128", "default"]
)
@pytest.mark.parametrize("masked", [False, True])
def test_nearest_sample_logit_boxed(rng, masked, tiling, layout):
    """Bitwise equal to the TPU's boxed kernel (interpret mode) everywhere,
    the -1e10 fill included; equal to the dense projection inside the boxes."""
    xyz, samp, logits, svalid, pvalid, boxes = _proj_case(rng, npts=512, r=12, masked=masked)
    if layout == "sorted":  # x-sorted points and boxes at the low end: tiles prune
        xyz[..., 0] = np.sort(xyz[..., 0], axis=1)
        boxes[..., 0] = np.minimum(boxes[..., 0], -1.0)
        boxes[..., 3] = np.minimum(boxes[..., 3], -0.5)
    args = (xyz, samp, logits, boxes, svalid, pvalid)
    got = n(ops.nearest_sample_logit_boxed(*(t(a) for a in args), **tiling))
    want = np.asarray(jops.nearest_sample_logit_boxed(
        *(jnp.asarray(a) for a in args), impl="pallas", **tiling))
    np.testing.assert_array_equal(got, want)
    dense = n(ops.nearest_sample_logit(t(xyz), t(samp), t(logits), t(svalid)))
    inside = n(ops.box_contains(t(boxes), t(xyz), t(pvalid)))
    assert inside.any()
    np.testing.assert_array_equal(got[inside], dense[inside])
    if layout == "sorted" and tiling:
        assert (got == -1e10).any() and ((got == -1e10) != (dense == -1e10)).any()


def test_tile_relevance_matches_jax(rng):
    xyz, _, _, _, pvalid, boxes = _proj_case(rng, npts=500, r=13)
    tn, npad, rb, rpad = ops.mask_project.boxed_layout(500, 13, 8, 128)
    assert (tn, npad, rb, rpad) == (128, 512, 8, 16)
    got = ops.tile_relevance(t(xyz), t(pvalid), t(boxes), tn, npad, rb, rpad)
    want = jmask._tile_relevance(jnp.asarray(xyz), jnp.asarray(pvalid), jnp.asarray(boxes),
                                 tn, npad, rb, rpad)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert got.dtype == torch.int32


def test_gather_and_group_point(rng):
    pts = rng.normal(size=(2, 30, 4)).astype(np.float32)
    idx2 = rng.integers(0, 30, (2, 7)).astype(np.int32)
    idx3 = rng.integers(0, 30, (2, 7, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        n(ops.gather_point(t(pts), t(idx2))),
        np.asarray(jops.gather_point(jnp.asarray(pts), jnp.asarray(idx2))))
    np.testing.assert_array_equal(
        n(ops.group_point(t(pts), t(idx3))),
        np.asarray(jops.group_point(jnp.asarray(pts), jnp.asarray(idx3))))


def _index_add_oracle(src, idx, n_out):
    """``out[b, idx[b, p]] += src[b, p]`` one position at a time, in
    ascending ``p``, in float32 from +0.0."""
    out = np.zeros((src.shape[0], n_out, src.shape[2]), np.float32)
    for b in range(src.shape[0]):
        for p_ in range(src.shape[1]):
            out[b, idx[b, p_]] = (out[b, idx[b, p_]] + src[b, p_]).astype(np.float32)
    return out


def _repeated_indices(rng, b, m, n_out):
    idx = rng.integers(0, n_out, (b, m)).astype(np.int32)
    idx[:, ::3] = idx[:, :1]  # a third of the positions on one index
    idx[idx == n_out - 1] = 0  # the last row gets nothing
    return idx


def test_index_add_rows_sums_in_ascending_position(rng):
    """The plain version of the gather backward against the sequential
    oracle, bitwise, with many positions on one index and an empty row."""
    src = rng.standard_normal((3, 90, 4)).astype(np.float32)
    idx = _repeated_indices(rng, 3, 90, 11)
    got = n(ops.index_add_rows(t(src), t(idx), 11))
    np.testing.assert_array_equal(got, _index_add_oracle(src, idx, 11))
    assert not got[:, -1].any()


@pytest.mark.parametrize("grouped", [False, True])
def test_gather_backward_matches_oracle_and_jax(rng, grouped):
    """``gather_point`` / ``group_point`` gradients: bitwise the ascending-
    position oracle and ``jax.grad`` of the JAX gathers on the CPU."""
    pts = rng.standard_normal((2, 20, 5)).astype(np.float32)
    idx = _repeated_indices(rng, 2, 60, 20)
    if grouped:
        idx = idx.reshape(2, 12, 5)
    g = rng.standard_normal((*idx.shape, 5)).astype(np.float32)
    tp = t(pts).requires_grad_(True)
    fwd, jfwd = (ops.group_point, jops.group_point) if grouped else (ops.gather_point,
                                                                     jops.gather_point)
    (fwd(tp, t(idx)) * t(g)).sum().backward()
    want = _index_add_oracle(g.reshape(2, 60, 5), idx.reshape(2, 60), 20)
    np.testing.assert_array_equal(n(tp.grad), want)
    jg = jax.grad(lambda p: jnp.sum(jfwd(p, jnp.asarray(idx)) * jnp.asarray(g)))(
        jnp.asarray(pts))
    np.testing.assert_array_equal(n(tp.grad), np.asarray(jg))


def _boxes(rng, b, r):
    c = rng.uniform(0, 2, (b, r, 3))
    half = rng.uniform(0.1, 0.6, (b, r, 3))
    return np.concatenate([c - half, c + half], axis=-1).astype(np.float32)


def test_box_iou(rng):
    a, b = _boxes(rng, 2, 9), _boxes(rng, 2, 7)
    np.testing.assert_array_equal(
        n(ops.box_iou(t(a), t(b))), np.asarray(jops.box_iou(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("masked", [False, True])
def test_nms_3d_batched(rng, masked):
    boxes = _boxes(rng, 3, 24)
    scores = rng.uniform(0, 1, (3, 24)).astype(np.float32)
    scores[:, 5] = scores[:, 6]  # equal scores: the stable sort keeps input order
    valid = rng.uniform(size=(3, 24)) > 0.2
    got = n(ops.nms_3d_batched(t(boxes), t(scores), 0.25, _tv(valid, masked)))
    want = np.asarray(jops.nms_3d_batched(
        jnp.asarray(boxes), jnp.asarray(scores), 0.25, _mask(valid, masked)))
    np.testing.assert_array_equal(got, want)
    for bi in range(3):
        np.testing.assert_array_equal(
            got[bi], oracles.nms_oracle(
                boxes[bi], scores[bi], 0.25, valid[bi] if masked else None))


@pytest.mark.parametrize("kind", ["ties", "nan", "signed_zero", "all_invalid"])
@pytest.mark.parametrize("masked", [False, True])
def test_nms_3d_batched_score_order_matches_jax(rng, kind, masked):
    """The order the CUDA kernel ranks by, held on the plain route against
    the JAX package's ``nms_3d_batched`` (XLA): tied scores keep input
    order, a NaN score (either sign) sorts last, after the invalid boxes,
    -0 and 0 tie, and an all-invalid scene keeps nothing (unmasked: every
    score -inf, all tied). The boxes overlap
    heavily, so that the order decides the keep mask."""
    c = rng.uniform(0, 1.5, (3, 40, 3))
    half = rng.uniform(0.3, 0.7, (3, 40, 3))
    boxes = np.concatenate([c - half, c + half], axis=-1).astype(np.float32)
    scores = rng.uniform(0, 1, (3, 40)).astype(np.float32)
    valid = rng.uniform(size=(3, 40)) > 0.2
    if kind == "ties":
        scores = np.floor(scores * 4) / 4
    elif kind == "nan":
        scores[:, ::3] = np.nan
        scores[:, 1::7] = -np.nan
    elif kind == "signed_zero":
        scores[:, ::2] = 0.0
        scores[:, 1::4] = -0.0
    else:  # every box invalid; unmasked, every score at -inf (tied)
        valid[:] = False
        scores[:] = -np.inf
    got = n(ops.nms_3d_batched(t(boxes), t(scores), 0.25, _tv(valid, masked)))
    want = np.asarray(jops.nms_3d_batched(
        jnp.asarray(boxes), jnp.asarray(scores), 0.25, _mask(valid, masked), impl="xla"))
    np.testing.assert_array_equal(got, want)
    if kind == "all_invalid" and masked:
        assert not got.any()


def _nms_case(rng, b, r, chain):
    """Random boxes with tied scores, plus a chain of ``chain`` boxes sliding
    along x, each overlapping the next above 0.25 IoU (but not the one
    after), with descending scores: greedy suppression alternates along it,
    which takes the Jacobi loop one step per link (more than one round of 8
    when ``chain > 8``)."""
    boxes = _boxes(rng, b, r)
    scores = rng.uniform(0, 1, (b, r)).astype(np.float32)
    scores[:, 5] = scores[:, 6]  # equal scores: the stable sort keeps input order
    scores[:, 7] = scores[:, 6]
    x = 10.0 + 0.35 * np.arange(chain, dtype=np.float32)
    boxes[:, :chain] = np.stack([x - 0.5, np.full_like(x, 9.5), np.full_like(x, 9.5),
                                 x + 0.5, np.full_like(x, 10.5), np.full_like(x, 10.5)], -1)
    scores[:, :chain] = 2.0 - np.arange(chain, dtype=np.float32) / r
    valid = rng.uniform(size=(b, r)) > 0.2
    valid[:, :chain] = True
    return boxes, scores, valid


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_nms_3d_batched_deep_chain(rng, masked, jax_impl):
    """The plain loop against JAX's Jacobi loop (``xla``) and the TPU's
    sequential ``_nms_kernel`` (``pallas``, interpret mode) and the oracle,
    with a suppression chain 20 deep."""
    boxes, scores, valid = _nms_case(rng, 3, 40, chain=20)
    got = n(ops.nms_3d_batched(t(boxes), t(scores), 0.25, _tv(valid, masked), impl="plain"))
    want = np.asarray(jops.nms_3d_batched(
        jnp.asarray(boxes), jnp.asarray(scores), 0.25, _mask(valid, masked), impl=jax_impl))
    np.testing.assert_array_equal(got, want)
    for bi in range(3):
        np.testing.assert_array_equal(
            got[bi], oracles.nms_oracle(boxes[bi], scores[bi], 0.25,
                                        valid[bi] if masked else None))
    np.testing.assert_array_equal(got[:, :20], np.tile([True, False], 10)[None].repeat(3, 0))
    np.testing.assert_array_equal(
        got, n(ops.nms_3d_batched(t(boxes), t(scores), 0.25, _tv(valid, masked))))  # auto


def test_nms_3d_batched_beyond_1024_boxes(rng):
    """1025 boxes (above the 1024 the first NMS kernel took): the plain
    loop's keep mask equals the JAX package's."""
    boxes, scores, valid = _nms_case(rng, 1, 1025, chain=40)
    got = n(ops.nms_3d_batched(t(boxes), t(scores), 0.25, t(valid)))
    want = np.asarray(jops.nms_3d_batched(jnp.asarray(boxes), jnp.asarray(scores), 0.25, valid))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_nms_3d(rng, masked):
    boxes, scores, valid = _nms_case(rng, 1, 24, chain=10)
    got = n(ops.nms_3d(t(boxes[0]), t(scores[0]), 0.25, t(valid[0]) if masked else None))
    want = np.asarray(jnms.nms_3d(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.25,
                                  valid[0] if masked else None, impl="pallas"))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (24,) and got.dtype == bool


def test_nms_refuses_unknown_impl():
    with pytest.raises(ValueError, match="auto\\|cuda\\|plain"):
        ops.nms_3d_batched(torch.zeros(1, 2, 6), torch.zeros(1, 2), 0.25, impl="pallas")


@pytest.mark.parametrize(
    "call",
    [
        lambda: ops.farthest_point_sample(4, torch.zeros(1, 8, 3), impl="cuda"),
        lambda: ops.three_nn(torch.zeros(1, 8, 3), torch.zeros(1, 4, 3), impl="cuda"),
        lambda: ops.query_box_group(torch.zeros(1, 2, 6), 4, torch.zeros(1, 8, 3), impl="cuda"),
        lambda: ops.query_ball_group_multi(
            (0.1,), (4,), torch.zeros(1, 8, 3), torch.zeros(1, 2, 3), impl="cuda"),
        lambda: ops.three_interpolate_mm(
            torch.zeros(1, 4, 2), torch.zeros(1, 8, 3, dtype=torch.int32), torch.zeros(1, 8, 3),
            impl="cuda"),
        lambda: ops.nearest_sample_logit(
            torch.zeros(1, 8, 3), torch.zeros(1, 2, 4, 3), torch.zeros(1, 2, 4), impl="cuda"),
        lambda: ops.nearest_sample_logit_boxed(
            torch.zeros(1, 8, 3), torch.zeros(1, 2, 4, 3), torch.zeros(1, 2, 4),
            torch.zeros(1, 2, 6), impl="cuda"),
        lambda: ops.query_box_group(torch.zeros(1, 2, 6), 4, torch.zeros(1, 8, 3), impl="cuda",
                                    select="strided"),
        lambda: ops.query_ball_group_multi(
            (0.1,), (4,), torch.zeros(1, 8, 3), torch.zeros(1, 2, 3), impl="cuda",
            select="strided"),
        lambda: ops.query_ball_point_multi(
            (0.1,), (4,), torch.zeros(1, 8, 3), torch.zeros(1, 2, 3), impl="cuda"),
        lambda: ops.query_ball_point_multi(
            (0.1,), (4,), torch.zeros(1, 8, 3), torch.zeros(1, 2, 3), impl="cuda",
            select="strided"),
        lambda: ops.nms_3d_batched(torch.zeros(1, 2, 6), torch.zeros(1, 2), 0.25, impl="cuda"),
        lambda: ops.index_add_rows(torch.zeros(1, 4, 2), torch.zeros(1, 4, dtype=torch.int32), 3,
                                   impl="cuda"),
        lambda: ops.three_interpolate_fp(
            torch.zeros(1, 4, 2), torch.zeros(1, 8, 3, dtype=torch.int32), torch.zeros(1, 8, 3),
            torch.zeros(1, 8, 5), impl="cuda"),
        lambda: ops.nn_argmin_pair(torch.zeros(1, 8, 3), torch.zeros(1, 4, 3), impl="cuda"),
    ],
    ids=["fps", "three_nn", "box_group", "ball_group", "interp_mm", "mask_project",
         "mask_project_boxed", "box_group_strided", "ball_group_strided", "ball_query",
         "ball_query_strided", "nms", "index_add", "interp_fp", "nn_argmin_pair"],
)
def test_cuda_impl_refuses_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


def test_three_nn_refuses_fewer_than_three_sources():
    with pytest.raises(ValueError, match="at least 3"):
        ops.three_nn(torch.zeros(1, 8, 3), torch.zeros(1, 2, 3))


def _op_samples():
    """One small CPU call of every registered ``gspn::`` op (its plain
    version)."""
    from gspn_tpu_torch.ops import mask_project as tmask

    gen = torch.Generator().manual_seed(0)
    xyz = torch.rand((2, 64, 3), generator=gen)
    valid = torch.rand((2, 64), generator=gen) > 0.2
    q = xyz[:, :5] + 0.01
    lo = torch.rand((2, 6, 3), generator=gen) * 0.6
    boxes = torch.cat([lo, lo + 0.1 + torch.rand((2, 6, 3), generator=gen) * 0.5], dim=-1)
    scores = torch.rand((2, 6), generator=gen)
    idx = torch.randint(0, 7, (2, 10, 3), generator=gen, dtype=torch.int32)
    sampled = torch.rand((2, 3, 4, 3), generator=gen)
    logits = torch.randn((2, 3, 4), generator=gen)
    svalid = torch.rand((2, 3, 4), generator=gen) > 0.2
    tn, npad, rb, rpad = tmask.boxed_layout(64, 3, 8, 32)
    rel = tmask.tile_relevance(xyz, valid, boxes[:, :3], tn, npad, rb, rpad)
    g = torch.ops.gspn
    return {
        "fps": (g.fps, (xyz, valid, 8, "plain")),
        "ball_query": (g.ball_query, (xyz, q, valid, [0.3, 0.6], [4, 8], "strided", "plain")),
        "ball_group": (g.ball_group, (xyz, q, valid, [0.3, 0.6], [4, 8], "first", "plain")),
        "box_group": (g.box_group, (boxes, xyz, valid, 8, "first", "plain")),
        "three_nn": (g.three_nn, (xyz[:, :10], xyz[:, 10:17], valid[:, 10:17], "plain")),
        "three_interpolate_mm": (g.three_interpolate_mm, (
            torch.randn((2, 7, 5), generator=gen).requires_grad_(), idx,
            torch.rand((2, 10, 3), generator=gen).requires_grad_(), "plain")),
        "three_interpolate_fp": (g.three_interpolate_fp, (
            torch.randn((2, 7, 5), generator=gen).requires_grad_(), idx,
            torch.rand((2, 10, 3), generator=gen).requires_grad_(),
            torch.randn((2, 10, 4), generator=gen).requires_grad_(), "plain")),
        "nearest_sample_logit": (g.nearest_sample_logit, (xyz, sampled, logits, svalid, "plain")),
        "nearest_sample_logit_boxed": (g.nearest_sample_logit_boxed, (
            xyz, sampled, logits, svalid, rel, rb, tn, "plain")),
        "nms_3d_batched": (g.nms_3d_batched, (boxes, scores, None, 0.25, "plain")),
        "nn_argmin": (g.nn_argmin, (xyz[:, :10], xyz[:, 10:30], valid[:, 10:30], "plain")),
        "nn_argmin_pair": (g.nn_argmin_pair, (xyz[:, :10], xyz[:, 10:30], valid[:, :10],
                                              valid[:, 10:30], "plain")),
        "index_add_rows": (g.index_add_rows, (torch.randn((2, 9, 4), generator=gen),
                                              idx.reshape(2, 30)[:, :9], 7, "plain")),
    }


_OPS = ["fps", "ball_query", "ball_group", "box_group", "three_nn", "three_interpolate_mm",
        "three_interpolate_fp", "nearest_sample_logit", "nearest_sample_logit_boxed",
        "nms_3d_batched", "nn_argmin", "nn_argmin_pair", "index_add_rows"]


@pytest.mark.parametrize("name", _OPS)
def test_registered_op_passes_opcheck(name):
    """Every kernel call is an op of the ``gspn`` namespace
    (``ops.common.gspn_op``, so ``torch.export`` keeps it as one opaque
    node): its schema, its fake version's shapes and dtypes against the
    real call's, its outputs not aliasing its inputs, and the FP
    interpolations' registered backward (their float inputs require
    gradients) (``torch.library.opcheck``)."""
    op, args = _op_samples()[name]
    torch.library.opcheck(op, args)


def test_every_kernel_has_a_registered_op():
    assert sorted(_OPS) == sorted(
        name for name in dir(torch.ops.gspn) if isinstance(getattr(torch.ops.gspn, name),
                                                          torch._ops.OpOverloadPacket))
