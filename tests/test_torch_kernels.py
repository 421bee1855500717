"""Each hand-written CUDA kernel of ``gspn_tpu_torch`` against its plain
PyTorch version, on the card, at the inference and training slices'
shapes, and one training step's kernel path against its plain path.

Needs an NVIDIA GPU with ``nvcc`` (the kernels build at first use); skipped
elsewhere. Run on the card with ``python -m pytest tests/test_torch_kernels.py``.
Integer outputs must be equal; coordinates and distances bitwise equal
(the kernels compile with ``-fmad=false`` and write the distance with
round-to-nearest intrinsics in the plain version's order).
"""

import numpy as np
import pytest
import torch

from gspn_tpu_torch import ops
from gspn_tpu_torch.data import synthetic
from gspn_tpu_torch.ops import ball_group as tball
from gspn_tpu_torch.ops import ball_query as tquery
from gspn_tpu_torch.ops import box_group as tbox
from gspn_tpu_torch.ops import chamfer as tchamfer
from gspn_tpu_torch.ops import fps as tfps
from gspn_tpu_torch.ops import grouping as tgroup
from gspn_tpu_torch.ops import interpolate as tinterp
from gspn_tpu_torch.ops import mask_project as tmask
from gspn_tpu_torch.ops import nms as tnms
from gspn_tpu_torch.train import steps as tsteps
from gspn_tpu_torch.utils import bench_slice

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _scenes(dev, b, n, seed=0, pad_frac=0.1):
    sb = synthetic.scene_batch(np.random.default_rng(seed), b, n_points=n, max_instances=8)
    valid = sb["valid"].copy()
    valid[:, n - int(n * pad_frac):] = False
    return torch.from_numpy(sb["xyz"]).to(dev), torch.from_numpy(valid).to(dev)


def _equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a, b), (a != b).sum().item()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,n,npoint", [(64, 1024, 128), (8, 8192, 128), (8, 64, 16)])
def test_fps_kernel(dev, rows, n, npoint, masked):
    xyz, valid = _scenes(dev, rows, n)
    v = valid if masked else None
    before = tfps.KERNEL.launches
    got = ops.farthest_point_sample(npoint, xyz, v, impl="cuda")
    torch.cuda.synchronize()
    assert tfps.KERNEL.launches == before + 1
    _equal(got, ops.farthest_point_sample(npoint, xyz, v, impl="plain"))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,n,npoint", [
    (3, 1, 4), (3, 31, 40), (3, 33, 40), (2, 1023, 64), (2, 1025, 64), (2, 8193, 32),
    (2, 14272, 64),  # each points-a-thread choice and its edges; npoint > n
    (64, 32, 8), (64, 128, 32), (8, 64, 16), (5, 96, 24),  # short rows share a CTA
    (8, 4096, 1),  # npoint = 1
])
def test_fps_kernel_edges(dev, rows, n, npoint, masked):
    """Bitwise the plain version at every register layout of the kernel;
    masked, row 0 keeps one to three valid points (the picks past them
    follow the plain argmax) and the last row none (index 0 at every
    pick)."""
    xyz, valid = _scenes(dev, rows, n, pad_frac=0.0)
    v = None
    if masked:
        v = valid.clone()
        v[0] = False
        v[0, n // 2::max(1, n // 3)] = True
        v[-1] = False
    before = tfps.KERNEL.launches
    got = ops.farthest_point_sample(npoint, xyz, v, impl="cuda")
    torch.cuda.synchronize()
    assert tfps.KERNEL.launches == before + 1
    _equal(got, ops.farthest_point_sample(npoint, xyz, v, impl="plain"))
    if masked:
        assert not got[-1].any()


@pytest.mark.parametrize("n", [32, 1024, 8192])
def test_fps_kernel_ties(dev, n):
    """Every point four times over (equal distances everywhere): ties go to
    the lowest index, bitwise the plain version."""
    xyz, _ = _scenes(dev, 4, n // 4)
    xyz = xyz.repeat(1, 4, 1)
    got = ops.farthest_point_sample(64, xyz, impl="cuda")
    _equal(got, ops.farthest_point_sample(64, xyz, impl="plain"))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,n,npoint", [(2, 14273, 64), (1, 65536, 128), (4, 16384, 64),
                                           (1, 131072, 64)])
def test_fps_cluster_kernel(dev, rows, n, npoint, masked):
    """Rows beyond one block's shared memory, on a cluster of CTAs: bitwise
    the plain version; masked, the last row is all invalid (index 0 on every
    pick)."""
    xyz, valid = _scenes(dev, rows, n)
    v = None
    if masked:
        v = valid.clone()
        v[-1] = False
    before = tfps.CLUSTER_KERNEL.launches
    got = ops.farthest_point_sample(npoint, xyz, v, impl="cuda")
    torch.cuda.synchronize()
    assert tfps.CLUSTER_KERNEL.launches == before + 1
    _equal(got, ops.farthest_point_sample(npoint, xyz, v, impl="plain"))
    if masked:
        assert not got[-1].any()


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
def test_fps_cluster_kernel_at_every_cluster_size(dev, cluster):
    """A row of 20000 points (its slice does not divide evenly) at every
    cluster size that holds it: bitwise the plain version."""
    xyz, valid = _scenes(dev, 1, 20000)
    got = tfps._fps_cuda(xyz, 96, valid, cluster=cluster)
    _equal(got, ops.farthest_point_sample(96, xyz, valid, impl="plain"))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
def test_fps_cluster_kernel_ties_across_ctas(dev, cluster, masked):
    """A row of 20000 points whose second half repeats the first (point j +
    10000 is point j): every distance ties with one in another CTA's slice,
    and the lower index must win at every cluster size, as in the plain
    version."""
    xyz, valid = _scenes(dev, 1, 10000, pad_frac=0.0)
    xyz = xyz.repeat(1, 2, 1)
    v = valid.repeat(1, 2) if masked else None
    before = tfps.CLUSTER_KERNEL.launches
    got = tfps._fps_cuda(xyz, 96, v, cluster=cluster)
    torch.cuda.synchronize()
    assert tfps.CLUSTER_KERNEL.launches == before + 1
    _equal(got, ops.farthest_point_sample(96, xyz, v, impl="plain"))
    assert (got < 10000).all()


def test_fps_kernel_refuses_rows_beyond_shared_memory(dev):
    xyz = torch.zeros((1, tfps.FPS_CLUSTER_MAX_N + 1, 3), device=dev)
    with pytest.raises(ValueError, match=f"at most {tfps.FPS_CLUSTER_MAX_N}"):
        ops.farthest_point_sample(4, xyz, impl="cuda")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "b,n,radii,ks,m",
    [
        (8, 8192, (0.25, 0.5, 1.0), (32, 64, 128), 64),  # GSPN crops
        (8, 8192, (0.1,), (32,), 1024),  # SA1
        (2, 100, (0.3, 0.6), (8, 16), 7),  # ragged sizes
    ],
)
def test_ball_group_kernel(dev, b, n, radii, ks, m, masked):
    xyz, valid = _scenes(dev, b, n)
    q = xyz[:, torch.randperm(n, generator=torch.Generator().manual_seed(1))[:m].to(dev)]
    q[:, -1] = 100.0  # a ball with no point: index 0, point 0's coordinates
    v = valid if masked else None
    got = ops.query_ball_group_multi(radii, ks, xyz, q, v, impl="cuda")
    want = ops.query_ball_group_multi(radii, ks, xyz, q, v, impl="plain")
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        for x, y in zip(g, w, strict=True):
            _equal(x, y)


def _ball_equal(xyz, q, v, radii, ks):
    """The first-K kernel bitwise the plain version."""
    before = tball.KERNEL.launches
    got = ops.query_ball_group_multi(radii, ks, xyz, q, v, impl="cuda")
    torch.cuda.synchronize()
    assert tball.KERNEL.launches == before + 1
    want = ops.query_ball_group_multi(radii, ks, xyz, q, v, impl="plain")
    for g, w in zip(got, want, strict=True):
        for x, y in zip(g, w, strict=True):
            _equal(x, y)
    return got


def _split_queries(split, b):
    """Queries a scene for which the kernel's rule (``group_first_split`` in
    ``csrc/group_first.cuh``) takes ``split`` warps a query over a scene of
    at least 512 x ``split`` points: B x M = 3072 / split - B lies within
    4096 / split warps and above half that. One short of a whole CTA, so
    the last CTA of each scene has an empty query slot."""
    return 3072 // (split * b) - 1


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "b,n,radii,ks,m",
    [
        (8, 1024, (0.2,), (32,), 256),  # SA2
        (8, 256, (0.4,), (32,), 64),  # SA3
        (8, 64, (0.8,), (32,), 16),  # SA4: one step, tested from device memory
        (3, 128, (0.5, 1.0), (8, 64), 10),  # the largest such scene
        (3, 129, (0.5, 1.0), (8, 64), 10),  # the smallest staged one
        (4, 4096, (0.25, 0.5, 1.0), (64, 128, 256), 64),  # training crops
        (2, 4096, (0.1, 0.2, 0.4, 0.8), (8, 16, 32, 64), 40),  # 4 scales
        (3, 8192, (0.3,), (32,), 1),  # M = 1
        (2, 5000, (0.2, 0.4), (16, 48), 70),  # N not a multiple of 4: plain staging
        (2, 4100, (0.2, 0.4), (16, 48), 70),  # N % 16 = 4: cp.async only unmasked
        (1, 65536, (0.1,), (32,), 1024),  # whole-scene SA1: 32 tiles
        (1, 8192, (0.25, 0.5, 1.0), (32, 64, 128), 64),  # 1 x 64 crops: 16 warps a query
        (1, 65536, (0.25, 0.5, 1.0), (32, 64, 128), 64),  # whole-scene crops: 16
    ],
)
def test_ball_group_kernel_shapes(dev, b, n, radii, ks, m, masked):
    xyz, valid = _scenes(dev, b, n)
    q = _centres(dev, xyz, m) if m > 1 else xyz[:, 5:6].clone()  # M = 1: not empty
    _ball_equal(xyz, q, valid if masked else None, radii, ks)


@pytest.mark.parametrize("invalid", [0.0, 0.1, 0.6], ids=["all_valid", "tail_10", "tail_60"])
def test_ball_group_kernel_single_object_crop(dev, invalid):
    """The single-object preset's crop (``shapenet_config(4096)``): one
    radius of 2.0 with K = 4096 around 64 seeds of 4 unit objects of 4096
    points, nearly every point a hit. With a tail of invalid points every
    row holds fewer hits than K and runs its tail fill (slots past the
    count repeat the first hit). (K above the point count is refused by
    both packages' plain versions.)"""
    sb = synthetic.object_scene_batch(np.random.default_rng(0), 4, 4096)
    xyz = torch.from_numpy(sb["xyz"]).to(dev)
    valid = torch.from_numpy(sb["valid"]).to(dev)
    valid[:, 4096 - int(4096 * invalid):] = False
    q = ops.gather_point(xyz, ops.farthest_point_sample(64, xyz, valid))
    (idx, cnt, _), = _ball_equal(xyz, q, valid if invalid else None, (2.0,), (4096,))
    assert idx.shape == (4, 64, 4096) and (cnt > 4096 * (1 - invalid) * 0.5).all()
    if invalid:
        assert (cnt < 4096).all()
        tail = torch.arange(4096, device=dev) >= cnt[..., None]
        assert (idx == idx[..., :1])[tail].all()


@pytest.mark.parametrize("split", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("b,n", [(1, 8192), (3, 8192), (8, 8192), (2, 8195), (1, 65536)])
def test_ball_group_kernel_at_every_split(dev, b, n, split):
    """A query's scan split over 1-16 warps (``_split_queries``) gives the
    serial scan's slots: one scene, three and eight scenes (a CTA never
    crosses a scene), a ragged scene staged without cp.async, a scene of
    32 tiles."""
    xyz, valid = _scenes(dev, b, n)
    _ball_equal(xyz, _centres(dev, xyz, _split_queries(split, b)), valid,
                (0.25, 0.5, 1.0), (32, 64, 128))


@pytest.mark.parametrize("split", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("last", [2047, 2048])
def test_ball_group_kernel_fills_at_a_tile_edge(dev, split, last):
    """A ball whose K-th hit is the last point of the first tile (2047) or
    the first of the second (2048), with hits after it in every tile; the
    other queries (``_split_queries``) sit about the far points."""
    gen = torch.Generator().manual_seed(11)
    n, k = 8192, 32
    xyz = torch.rand((1, n, 3), generator=gen) * 4 + 2  # all outside the ball
    hits = torch.cat([torch.randperm(last, generator=gen)[:k - 1], torch.tensor([last])])
    xyz[0, hits] = torch.rand((k, 3), generator=gen) * 0.1
    xyz[0, last + 1::97] = torch.rand((len(range(last + 1, n, 97)), 3), generator=gen) * 0.1
    q = torch.full((1, _split_queries(split, 1), 3), 3.0)
    q[0, 0] = 0.0
    got = _ball_equal(xyz.to(dev), q.to(dev), None, (0.5,), (k,))
    assert got[0][1][0, 0].item() == k and got[0][0][0, 0, -1].item() == last


@pytest.mark.parametrize("split", [1, 4, 16])
def test_ball_group_kernel_duplicated_points(dev, split):
    """Every point twice (the copy 4096 indices on, two tiles later) and
    invalid points among them, at ``split`` warps a query."""
    xyz, valid = _scenes(dev, 2, 4096)
    xyz, valid = xyz.repeat(1, 2, 1), valid.repeat(1, 2)
    valid[:, 1::5] = False
    _ball_equal(xyz, _centres(dev, xyz, _split_queries(split, 2)), valid,
                (0.25, 0.5, 1.0), (32, 64, 128))


_BALL_CASES = [
    (8, 8192, (0.25, 0.5, 1.0), (32, 64, 128), 64),  # GSPN crops
    (8, 8192, (0.1,), (32,), 1024),  # SA1
    (1, 65536, (0.25, 0.5, 1.0), (32, 64, 128), 64),  # whole-scene crops
    (2, 100, (0.3, 0.6), (8, 16), 7),  # ragged sizes
]


def _centres(dev, xyz, m):
    q = xyz[:, torch.randperm(xyz.shape[1], generator=torch.Generator().manual_seed(1))[:m]
            .to(dev)]
    q[:, -1] = 100.0  # a ball with no point: index 0, point 0's coordinates
    return q


# the strided groups' plans: the wrapper's (None), each split with the
# scene staged, and direct (a warp a query, no staging)
_STRIDED_PLANS = [None, (1, False), (2, False), (4, False), (8, False), (16, False), (1, True)]
_PLAN_IDS = ["auto", "s1", "s2", "s4", "s8", "s16", "direct"]


def _ball_strided(xyz, q, v, radii, ks, plan):
    """The strided ball group's kernel at ``plan`` (None: through the entry
    point), bitwise the plain version; asserts one launch."""
    before = tball.STRIDED_KERNEL.launches
    if plan is None:
        got = ops.query_ball_group_multi(radii, ks, xyz, q, v, impl="cuda", select="strided")
    else:
        got = tball._ball_group_strided_cuda(radii, ks, xyz, q, v, plan=plan)
    torch.cuda.synchronize()
    assert tball.STRIDED_KERNEL.launches == before + 1
    want = ops.query_ball_group_multi(radii, ks, xyz, q, v, impl="plain", select="strided")
    for g, w in zip(got, want, strict=True):
        for x, y in zip(g, w, strict=True):
            _equal(x, y)
    return got


@pytest.mark.parametrize("plan", _STRIDED_PLANS, ids=_PLAN_IDS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,radii,ks,m", _BALL_CASES)
def test_ball_group_strided_kernel(dev, b, n, radii, ks, m, masked, plan):
    """Bitwise its plain version at every plan; where a ball overflows K,
    not first-K."""
    xyz, valid = _scenes(dev, b, n)
    q = _centres(dev, xyz, m)
    v = valid if masked else None
    got = _ball_strided(xyz, q, v, radii, ks, plan)
    first = ops.query_ball_group_multi(radii, ks, xyz, q, v, impl="cuda")
    if n > 1000:
        assert any(not torch.equal(g[0], f[0]) for g, f in zip(got, first, strict=True))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "b,n,radii,ks,m",
    [
        (8, 1024, (0.2,), (32,), 256),  # SA2
        (8, 256, (0.4,), (32,), 64),  # SA3
        (8, 64, (0.8,), (32,), 16),  # SA4
        (3, 128, (0.5, 1.0), (8, 64), 10),  # a scene of one 128-point step
        (3, 129, (0.5, 1.0), (8, 64), 10),  # one point into a second step
        (2, 4096, (0.1, 0.2, 0.4, 0.8), (8, 16, 32, 64), 40),  # 4 scales
        (3, 8192, (0.3,), (32,), 1),  # M = 1
        (2, 5000, (0.2, 0.4), (16, 48), 70),  # N not a multiple of 4: plain staging
        (2, 4100, (0.2, 0.4), (16, 48), 70),  # N % 16 = 4: cp.async only unmasked
        (1, 65536, (1.0,), (128,), 64),  # whole-scene r 1.0: total >> K
    ],
)
def test_ball_group_strided_kernel_shapes(dev, b, n, radii, ks, m, masked):
    """The entry point's plan at the SA levels' shapes and the edges of the
    staging, bitwise the plain version."""
    xyz, valid = _scenes(dev, b, n)
    q = _centres(dev, xyz, m) if m > 1 else xyz[:, 5:6].clone()
    got = _ball_strided(xyz, q, valid if masked else None, radii, ks, None)
    if n == 65536:
        assert (got[0][1][0, :-1] == 128).all()  # every ball but the empty one full


def _planted(dev, n, positions, seed=12):
    """A scene of ``n`` points far from every query (in [50, 54)^3) but for
    query i's hits at ``positions[i]``, within 0.1 of its centre (20 i, 0,
    0). Returns ``(xyz (1, n, 3), centres (1, Q, 3), boxes (1, Q, 6))``:
    balls of radius 0.5 and boxes of half-size 0.25 about the centres hold
    exactly those points."""
    gen = torch.Generator().manual_seed(seed)
    xyz = torch.rand((1, n, 3), generator=gen) * 4 + 50
    centres = torch.zeros((1, len(positions), 3))
    centres[0, :, 0] = torch.arange(len(positions), dtype=torch.float32) * 20
    for i, pos in enumerate(positions):
        pos = torch.as_tensor(pos, dtype=torch.long)
        xyz[0, pos] = centres[0, i] + (torch.rand((len(pos), 3), generator=gen) - 0.5) * 0.2
    boxes = torch.cat([centres - 0.25, centres + 0.25], dim=-1)
    return xyz.to(dev), centres.to(dev), boxes.to(dev)


def _planted_positions(n, k, seed=13):
    """Disjoint hit positions a query: a run of 3K across the first tile
    edge (2048; mid-scene in a shorter scene), the points next to every
    later tile edge and the first and last point, then K - 1, K, K + 1,
    2K + 1 and up to 40 K positions spread over the rest, and none."""
    mid = 2048 if n > 2048 + 2 * k else n // 2
    run = list(range(mid - k, mid + 2 * k))
    edges = sorted({e + d for e in range(4096, n, 2048) for d in (-2, -1, 0, 1)} | {0, n - 1})
    taken = set(run) | set(edges)
    rest = [j for j in torch.randperm(n, generator=torch.Generator().manual_seed(seed)).tolist()
            if j not in taken]
    out = [torch.tensor(run), torch.tensor(edges)]
    for c in (k - 1, k, k + 1, 2 * k + 1, min(40 * k, len(rest) // 2)):
        out.append(torch.tensor(sorted(rest[:c])))
        rest = rest[c:]
    return out + [torch.tensor([], dtype=torch.long)]


@pytest.mark.parametrize("plan", _STRIDED_PLANS, ids=_PLAN_IDS)
@pytest.mark.parametrize("n", [8192, 4100])
def test_ball_group_strided_kernel_planted_totals(dev, n, plan):
    """Balls holding hits across tile edges (2048, 4096, ...) and exactly
    K - 1, K, K + 1, 2K + 1 and 40 K points, and none: bitwise the plain
    version at every plan, each count min(total, K)."""
    k = 32
    pos = _planted_positions(n, k)
    xyz, centres, _ = _planted(dev, n, pos)
    got = _ball_strided(xyz, centres, None, (0.5,), (k,), plan)
    want_cnt = torch.tensor([min(len(p), k) for p in pos], dtype=torch.int32, device=dev)
    _equal(got[0][1][0], want_cnt)


@pytest.mark.parametrize("plan", _STRIDED_PLANS, ids=_PLAN_IDS)
def test_ball_group_strided_kernel_duplicated_points(dev, plan):
    """Every point twice (the copy 4096 indices on, two tiles later) and
    invalid points among them, at every plan."""
    xyz, valid = _scenes(dev, 2, 4096)
    xyz, valid = xyz.repeat(1, 2, 1), valid.repeat(1, 2)
    valid[:, 1::5] = False
    _ball_strided(xyz, _centres(dev, xyz, 40), valid, (0.25, 0.5, 1.0), (32, 64, 128), plan)


@pytest.mark.parametrize("select", ["first", "strided"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,radii,ks,m", _BALL_CASES + [
    (1, 65536, (0.1,), (32,), 1024),  # whole-scene SA1
    (8, 1024, (0.2,), (32,), 256),  # SA2: strided at the direct plan's limit
    (8, 64, (0.8,), (32,), 16),  # SA4: one step, first-K from device memory too
])
def test_ball_query_kernel(dev, b, n, radii, ks, m, masked, select):
    """Bitwise its plain version and the ball group's indices and counts."""
    xyz, valid = _scenes(dev, b, n)
    q = _centres(dev, xyz, m)
    v = valid if masked else None
    kernel = tquery.STRIDED_KERNEL if select == "strided" else tquery.KERNEL
    before = kernel.launches
    got = ops.query_ball_point_multi(radii, ks, xyz, q, v, impl="cuda", select=select)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = ops.query_ball_point_multi(radii, ks, xyz, q, v, impl="plain", select=select)
    grouped = ops.query_ball_group_multi(radii, ks, xyz, q, v, impl="cuda", select=select)
    for g, w, f in zip(got, want, grouped, strict=True):
        for x, y, z in zip(g, w, f[:2], strict=True):
            _equal(x, y)
            _equal(x, z)
    single = ops.query_ball_point(radii[0], ks[0], xyz, q, v, impl="cuda", select=select)
    for x, y in zip(single, got[0], strict=True):
        _equal(x, y)


@pytest.mark.parametrize("plan", [("first", s) for s in (1, 2, 4, 8, 16)]
                         + [("strided", p) for p in _STRIDED_PLANS[1:]],
                         ids=[f"first_s{s}" for s in (1, 2, 4, 8, 16)]
                         + [f"strided_{i}" for i in _PLAN_IDS[1:]])
@pytest.mark.parametrize("b,n,m", [(8, 8192, 64), (2, 8195, 70), (2, 4100, 40)])
def test_ball_query_kernel_at_the_ball_groups_plan(dev, b, n, m, plan):
    """The ball query and the ball group launched at the same plan (a
    first-K split, or a strided split or direct) give the same indices and
    counts, bitwise the plain version's: the same kernel with and without
    its coordinate stores."""
    xyz, valid = _scenes(dev, b, n)
    q = _centres(dev, xyz, m)
    radii, ks = (0.25, 0.5, 1.0), (32, 64, 128)
    select, p = plan
    if select == "first":
        got = tquery._ball_query_cuda(radii, ks, xyz, q, valid, split=p)
        grouped = tball._ball_group_cuda(radii, ks, xyz, q, valid, split=p)
    else:
        got = tquery.strided_scan_cuda(tquery.STRIDED_KERNEL, radii, ks, xyz, q, valid, False,
                                       plan=p)
        grouped = tball._ball_group_strided_cuda(radii, ks, xyz, q, valid, plan=p)
    torch.cuda.synchronize()
    want = ops.query_ball_point_multi(radii, ks, xyz, q, valid, impl="plain", select=select)
    for g, f, w in zip(got, grouped, want, strict=True):
        for x, y, z in zip(g, f[:2], w, strict=True):
            _equal(x, y)
            _equal(x, z)


def _rois(dev, xyz, r, seed=2, kind="random"):
    """Boxes about scene points: "random" half-sizes up to 0.5 (the first
    two near-empty, which exercises padding and empty rows), "small" ones
    (half 0.02: fewer than S points, so the scan reads the whole scene) or
    "empty" ones, moved off the scene."""
    b, n, _ = xyz.shape
    gen = torch.Generator().manual_seed(seed)
    c = xyz[:, torch.randperm(n, generator=gen)[:r].to(dev)]
    half = torch.rand((b, r, 3), generator=gen).to(dev) * 0.5
    half[:, :2] = 1e-4
    if kind == "small":
        half[:] = 0.02
    if kind == "empty":
        c = c + 100.0
    return torch.cat([c - half, c + half], dim=-1)


def _box_equal(boxes, s, xyz, v):
    """The first-S kernel, launched by "auto" on a CUDA tensor, bitwise the
    plain version."""
    before = tbox.KERNEL.launches
    got = ops.query_box_group(boxes, s, xyz, v)
    torch.cuda.synchronize()
    assert tbox.KERNEL.launches == before + 1
    want = ops.query_box_group(boxes, s, xyz, v, impl="plain")
    for x, y in zip(got, want, strict=True):
        _equal(x, y)
    return got


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,r,s,kind", [
    (8, 8192, 64, 64, "random"),  # the flagship's RoIs: 8 warps a box
    (2, 100, 5, 8, "random"),
    (1, 65536, 64, 64, "random"),  # the whole scene's: 16 warps a box
    (2, 8192, 64, 64, "small"),  # fewer than S points a box: the whole scene scanned
    (2, 8192, 20, 64, "empty"),  # index 0, point 0 minus the centre
    (2, 5000, 40, 64, "random"),  # N not a multiple of 4: plain staging
    (2, 4100, 40, 64, "random"),  # N % 16 = 4: cp.async only unmasked
])
def test_box_group_kernel(dev, b, n, r, s, kind, masked):
    xyz, valid = _scenes(dev, b, n)
    got = _box_equal(_rois(dev, xyz, r, kind=kind), s, xyz, valid if masked else None)
    if kind == "small":
        assert (got[1] < s).all() and got[1].any()
    if kind == "empty":
        assert not got[1].any() and not got[0].any()


@pytest.mark.parametrize("split", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("b,n", [(1, 8192), (3, 8195), (1, 65536)])
def test_box_group_kernel_at_every_split(dev, b, n, split):
    """A box's scan split over 1-16 warps (``_split_queries``: the box count
    the kernel's rule maps to ``split``) gives the serial scan's slots: one
    scene, three ragged ones staged without cp.async, a scene of 32 tiles."""
    xyz, valid = _scenes(dev, b, n)
    _box_equal(_rois(dev, xyz, _split_queries(split, b)), 64, xyz, valid)


def _box_strided(boxes, s, xyz, v, plan):
    """The strided box group's kernel at ``plan`` (None: through the entry
    point), bitwise the plain version; asserts one launch."""
    before = tbox.STRIDED_KERNEL.launches
    if plan is None:
        got = ops.query_box_group(boxes, s, xyz, v, impl="cuda", select="strided")
    else:
        got = tbox._box_group_strided_cuda(boxes, s, xyz, v, plan=plan)
    torch.cuda.synchronize()
    assert tbox.STRIDED_KERNEL.launches == before + 1
    want = ops.query_box_group(boxes, s, xyz, v, impl="plain", select="strided")
    for x, y in zip(got, want, strict=True):
        _equal(x, y)
    return got


@pytest.mark.parametrize("plan", _STRIDED_PLANS, ids=_PLAN_IDS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,r,s", [(8, 8192, 64, 64), (1, 65536, 64, 64), (2, 100, 5, 8)])
def test_box_group_strided_kernel(dev, b, n, r, s, masked, plan):
    xyz, valid = _scenes(dev, b, n)
    boxes = _rois(dev, xyz, r)
    v = valid if masked else None
    got = _box_strided(boxes, s, xyz, v, plan)
    if n > 1000:
        assert not torch.equal(got[0], ops.query_box_group(boxes, s, xyz, v, impl="cuda")[0])


@pytest.mark.parametrize("plan", _STRIDED_PLANS, ids=_PLAN_IDS)
@pytest.mark.parametrize("n", [8192, 4100, 128])
def test_box_group_strided_kernel_planted_totals(dev, n, plan):
    """Boxes holding hits across tile edges and exactly S - 1, S, S + 1,
    2S + 1 and up to 40 S points, and none, at every plan (also in a scene
    of one 128-point step); then the scene with every point twice."""
    s = 32 if n > 128 else 8
    pos = _planted_positions(n, s)
    xyz, _, boxes = _planted(dev, n, pos)
    got = _box_strided(boxes, s, xyz, None, plan)
    want_cnt = torch.tensor([min(len(p), s) for p in pos], dtype=torch.int32, device=dev)
    _equal(got[1][0], want_cnt)
    _box_strided(boxes, s, xyz.repeat(1, 2, 1), None, plan)


def _nms_case(dev, b, r, seed=6):
    """Random boxes with tied scores, plus (in every scene) a chain of
    boxes sliding along x, each overlapping the next above the threshold,
    scores descending along it: suppression depth r // 4."""
    gen = torch.Generator().manual_seed(seed)
    c = torch.rand((b, r, 3), generator=gen) * 4
    half = torch.rand((b, r, 3), generator=gen) * 0.6 + 0.1
    scores = torch.rand((b, r), generator=gen)
    scores[:, 1::5] = scores[:, ::5][:, : scores[:, 1::5].shape[1]]  # ties
    chain = r // 4
    c[:, :chain] = torch.tensor([10.0, 10.0, 10.0])
    c[:, :chain, 0] += torch.arange(chain, dtype=torch.float32) * 0.35
    half[:, :chain] = 0.5
    scores[:, :chain] = 2.0 - torch.arange(chain, dtype=torch.float32) / r
    boxes = torch.cat([c - half, c + half], dim=-1)
    valid = torch.rand((b, r), generator=gen) > 0.1
    valid[:, :chain] = True
    return boxes.to(dev), scores.to(dev), valid.to(dev)


# R: one box; a few; the main path's 64; one CTA's last (ONE_CTA_R) and
# the first above it (mask in a device buffer); the kernel's own ranking's
# last (SORT_MAX) and the first sorted by the wrapper; 2048 and 4096
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,r", [(1, 1), (3, 5), (8, 64), (2, 128), (2, 129), (2, 1024),
                                 (2, 1025), (1, 2048), (1, 4096)])
def test_nms_kernel(dev, b, r, masked):
    """Bitwise the plain route; at R = 64 the whole of ``nms_3d_batched`` is
    one device kernel (``torch.profiler``) besides one registry launch."""
    boxes, scores, valid = _nms_case(dev, b, r)
    v = valid if masked else None
    before = tnms.KERNEL.launches
    got = ops.nms_3d_batched(boxes, scores, 0.25, v, impl="cuda")
    torch.cuda.synchronize()
    assert tnms.KERNEL.launches == before + 1
    _equal(got, ops.nms_3d_batched(boxes, scores, 0.25, v, impl="plain"))
    assert tnms.KERNEL.launches == before + 1
    _equal(got, ops.nms_3d_batched(boxes, scores, 0.25, v))  # "auto" is the kernel
    assert tnms.KERNEL.launches == before + 2
    _equal(ops.nms_3d(boxes[0], scores[0], 0.25, None if v is None else v[0], impl="cuda"),
           got[0])
    if r == 64:
        from gspn_tpu_torch.utils.time_kernels import device_launches

        assert device_launches(lambda: ops.nms_3d_batched(boxes, scores, 0.25, v), 5) == 1.0


@pytest.mark.parametrize("r", [64, 300, 1100])
@pytest.mark.parametrize("kind", ["ties", "nan", "signed_zero", "all_invalid"])
def test_nms_kernel_score_order(dev, kind, r):
    """The kernel's order is ``torch.sort(-s, stable=True)``'s: tied scores
    keep input order, a NaN score sorts last (after the invalid boxes), -0
    and 0 tie; an all-invalid scene keeps nothing. Bitwise the plain route,
    with boxes that overlap heavily so that the order decides."""
    gen = torch.Generator().manual_seed(9)
    c = torch.rand((2, r, 3), generator=gen) * 1.5
    half = torch.rand((2, r, 3), generator=gen) * 0.4 + 0.3
    boxes = torch.cat([c - half, c + half], dim=-1).to(dev)
    scores = torch.rand((2, r), generator=gen)
    valid = torch.rand((2, r), generator=gen) > 0.2
    if kind == "ties":
        scores = (scores * 4).floor() / 4  # four distinct values
    elif kind == "nan":
        scores[:, ::3] = float("nan")
        scores[:, 1::7] = -float("nan")
    elif kind == "signed_zero":
        scores[:, ::2] = 0.0
        scores[:, 1::4] = -0.0
    else:
        valid[:] = False
    scores, valid = scores.to(dev), valid.to(dev)
    for v in (None, valid):
        got = ops.nms_3d_batched(boxes, scores, 0.25, v, impl="cuda")
        _equal(got, ops.nms_3d_batched(boxes, scores, 0.25, v, impl="plain"))
    if kind == "all_invalid":
        assert not got.any()


def test_nms_kernel_refuses_more_than_max_r_boxes(dev):
    boxes = torch.zeros((1, tnms.MAX_R + 1, 6), device=dev)
    with pytest.raises(ValueError, match=f"at most {tnms.MAX_R}"):
        ops.nms_3d_batched(boxes, torch.zeros((1, tnms.MAX_R + 1), device=dev), 0.25)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "b,n,m",
    [(8, 8192, 1024), (512, 8192, 64), (2, 100, 3), (8, 4096, 8192), (1, 4096, 65536)],
)
def test_three_nn_kernel(dev, b, n, m, masked):
    gen = torch.Generator().manual_seed(3)
    tgt = (torch.rand((b, n, 3), generator=gen) * 4).to(dev)
    src = (torch.rand((b, m, 3), generator=gen) * 4).to(dev)
    src[:, 1] = src[:, 0]  # equal distances: ties go to the lower index
    svalid = (torch.rand((b, m), generator=gen) > 0.3).to(dev)
    v = svalid if masked else None
    before = tinterp.KERNEL.launches
    got = ops.three_nn(tgt, src, v, impl="cuda")
    want = ops.three_nn(tgt, src, v, impl="plain")
    torch.cuda.synchronize()
    assert tinterp.KERNEL.launches == before + 1
    for a, w in zip(got, want, strict=True):
        _equal(a, w)


# three_nn_plan's edges: targets where T goes 1 -> 4 (524288) and where
# 2048 warps fill the card (65536: one slice; 65504: two); sources where a
# slice would keep fewer than 32 (S doubles at 64, 128, ...), at a tile's
# and a group's edge (512 sources for CTAs of 256 threads, groups of 32)
# and where long slices split further (4096 sources a slice)
@pytest.mark.parametrize("b,n,m", [(1, 65504, 300), (1, 65536, 300), (2, 8191, 511),
                                   (2, 8192, 512), (1, 16383, 513), (1, 524287, 64),
                                   (2, 262144, 65), (4, 100, 63), (4, 100, 64), (3, 500, 33),
                                   (1, 64, 4097), (1, 100, 131072)])
def test_three_nn_kernel_plan_edges(dev, b, n, m):
    gen = torch.Generator().manual_seed(5)
    tgt = (torch.rand((b, n, 3), generator=gen) * 4).to(dev)
    src = (torch.rand((b, m, 3), generator=gen) * 4).to(dev)
    svalid = (torch.rand((b, m), generator=gen) > 0.3).to(dev)
    for v in (None, svalid):
        for a, w in zip(ops.three_nn(tgt, src, v, impl="cuda"),
                        ops.three_nn(tgt, src, v, impl="plain"), strict=True):
            _equal(a, w)


@pytest.mark.parametrize("group", [1, 32])
@pytest.mark.parametrize("per", [1, 2, 4])
@pytest.mark.parametrize("split", [1, 2, 4, 8, 16, 32])
def test_three_nn_kernel_at_every_plan(dev, per, split, group):
    """Every (targets a thread, slices, group) forced: bitwise the plain version,
    with each source repeated half the range later, so that equal
    distances fall in different slices (the lower index must win), and a
    scene with fewer than 3 valid sources (two, then none)."""
    gen = torch.Generator().manual_seed(6)
    b, n, h = 3, 700, 1100
    tgt = (torch.rand((b, n, 3), generator=gen) * 4).to(dev)
    half = torch.rand((b, h, 3), generator=gen) * 4
    src = torch.cat([half, half], dim=1).to(dev)  # source j + h repeats j
    svalid = torch.rand((b, 2 * h), generator=gen) > 0.3
    svalid[1] = False
    svalid[1, [5, 2 * h - 5]] = True
    svalid[2] = False
    svalid = svalid.to(dev)
    for v in (None, svalid):
        got = tinterp._three_nn_cuda(tgt, src, v, plan=(per, split, group))
        want = ops.three_nn(tgt, src, v, impl="plain")
        for a, w in zip(got, want, strict=True):
            _equal(a, w)
        if v is None:  # the nearest source, then its repeat
            _equal(got[1][..., 1], got[1][..., 0] + h)


def _interp_idx(gen, b, n, m):
    idx = torch.randint(0, m, (b, n, 3), generator=gen, dtype=torch.int32)
    idx[:, ::7, 1] = idx[:, ::7, 0]  # repeated sources
    idx[:, ::11, 2] = idx[:, ::11, 0]
    idx[:, ::13, :] = idx[:, ::13, :1]
    return idx


@pytest.mark.parametrize(
    "b,n,m,c",
    [(8, 8192, 1024, 128), (8, 64, 16, 512), (1, 65536, 1024, 128), (2, 100, 5, 7),
     (3, 77, 9, 130),  # C not a multiple of 4 beyond one warp's columns
     (1, 4096, 2100, 1000)],  # the last above the TPU kernel's 8 MB source block
)
def test_interp_mm_kernel(dev, b, n, m, c):
    """The weights form (``three_interpolate_mm``): bitwise its plain
    version and the exact interpolation, one launch."""
    gen = torch.Generator().manual_seed(4)
    pts = torch.randn((b, m, c), generator=gen).to(dev)
    idx = _interp_idx(gen, b, n, m).to(dev)
    w = torch.rand((b, n, 3), generator=gen).to(dev)
    before = tinterp.MM_KERNEL.launches
    got = ops.three_interpolate_mm(pts, idx, w, impl="cuda")
    want = ops.three_interpolate_mm(pts, idx, w, impl="plain")
    torch.cuda.synchronize()
    assert tinterp.MM_KERNEL.launches == before + 1
    _equal(got, want)
    _equal(got, ops.three_interpolate(pts, idx, w))


def _fp_case(dev, b, n, m, c2, c1, seed=4, skip_offset=0):
    """Sources, indices (repeats included), three_nn-like squared
    distances with zeros and values below eps, and skip rows (or None);
    ``skip_offset`` floats shift the skip rows off a 16-byte boundary."""
    gen = torch.Generator().manual_seed(seed)
    pts = torch.randn((b, m, c2), generator=gen).to(dev)
    idx = _interp_idx(gen, b, n, m).to(dev)
    dist = torch.rand((b, n, 3), generator=gen).sort(dim=-1).values
    dist[:, ::5, 0] = 0.0
    dist[:, ::9, :2] = 1e-12
    dist = dist.to(dev)
    skip = None
    if c1:
        flat = torch.randn(b * n * c1 + skip_offset, generator=gen).to(dev)
        skip = flat[skip_offset:].view(b, n, c1)
    return pts, idx, dist, skip


def _fp_equal(dev, pts, idx, dist, skip, plan=None):
    before = tinterp.MM_KERNEL.launches
    if plan is None:
        got = ops.three_interpolate_fp(pts, idx, dist, skip, impl="cuda")
    else:
        got = tinterp._interp_mm_cuda(pts, idx, dist, skip, from_dist=True, plan=plan)
    torch.cuda.synchronize()
    assert tinterp.MM_KERNEL.launches == before + 1
    want = ops.three_interpolate_fp(pts, idx, dist, skip, impl="plain")
    _equal(got, want)
    composite = ops.three_interpolate(pts, idx, ops.three_interpolate_weights(dist))
    _equal(got, composite if skip is None else torch.cat([composite, skip], dim=-1))


@pytest.mark.parametrize(
    "b,n,m,c2,c1",
    [(8, 64, 16, 512, 256), (8, 256, 64, 256, 128), (8, 1024, 256, 256, 64),  # FP1-FP3
     (8, 8192, 1024, 128, 0), (1, 65536, 1024, 128, 0), (1, 64, 16, 512, 256),  # FP4, scene
     (2, 100, 5, 7, 3),  # C2 and C1 not multiples of 4: scalar loads
     (2, 50, 10, 8, 5),  # vector interpolation, scalar skip
     (3, 37, 11, 130, 0), (2, 1001, 40, 12, 300)],  # ragged rows and slices
)
def test_interp_fp_kernel(dev, b, n, m, c2, c1):
    """``three_interpolate_fp``: the weights from the distances, the
    interpolation and the skip concat in one launch, bitwise its plain
    version and the composite it replaces."""
    _fp_equal(dev, *_fp_case(dev, b, n, m, c2, c1))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_interp_fp_kernel_unaligned_skip(dev, offset):
    """Skip rows off a 16-byte boundary (a contiguous view at an odd
    offset) take scalar loads; the interpolation keeps its vector path."""
    _fp_equal(dev, *_fp_case(dev, 8, 64, 16, 512, 256, skip_offset=offset))


@pytest.mark.parametrize("plan", [(1, 1, 0), (8, 1, 0), (3, 2, 0), (1, 6, 0), (5, 100, 0),
                                  (8, 7, 0)])
def test_interp_fp_kernel_at_any_plan(dev, plan):
    """The direct form: rows a task 1-8 (ragged last task) and 1 to more
    slices than the row has chunks."""
    _fp_equal(dev, *_fp_case(dev, 2, 333, 40, 260, 132), plan=plan)


@pytest.mark.parametrize("plan,m", [((2048, 3, 32), 700), ((512, 3, 32), 700),
                                    ((1000, 3, 32), 1500), ((7, 3, 32), 700),
                                    ((1264, 3, 32), 1500)])
def test_interp_fp_kernel_staged_at_any_plan(dev, plan, m):
    """The staged form: chunks of 7 to 2048 rows (a ragged last chunk),
    slices of 32 channels, up to 1500 sources and 1264 rows, the most that
    fit in shared memory beside them."""
    _fp_equal(dev, *_fp_case(dev, 2, 5000, m, 96, 0), plan=plan)


def test_interp_fp_kernel_refuses_plans_beyond_its_limits(dev):
    args = _fp_case(dev, 1, 8, 4, 8, 0)
    args32 = _fp_case(dev, 1, 8, 4, 32, 0)
    big = _fp_case(dev, 1, 64, 4096, 64, 0)  # 4096 x 32 floats: beyond shared memory
    for a, plan in ((args, (0, 1, 0)), (args, (9, 1, 0)), (args, (1, 0, 0)),
                    (args, (16, 1, 32)),  # C not a multiple of the stage
                    (args, (16, 1, 8)), (args32, (16, 2, 16)),  # the stage is 32 channels
                    (big, (2049, 2, 32)), (big, (64, 2, 32))):
        with pytest.raises(RuntimeError, match="interp_mm failed to launch"):
            tinterp._interp_mm_cuda(*a, from_dist=True, plan=plan)
    skip = _fp_case(dev, 1, 64, 8, 64, 4)
    with pytest.raises(RuntimeError, match="interp_mm failed to launch"):
        tinterp._interp_mm_cuda(*skip, from_dist=True, plan=(64, 2, 32))  # skip rows


def test_interp_fp_kernel_nan_distance(dev):
    """A NaN distance passes the clamp (as ``torch.clamp`` lets it): its
    row is NaN in both versions, every other row bitwise."""
    pts, idx, dist, skip = _fp_case(dev, 2, 40, 8, 16, 4)
    dist[0, 3, 1] = float("nan")
    got = ops.three_interpolate_fp(pts, idx, dist, skip, impl="cuda")
    want = ops.three_interpolate_fp(pts, idx, dist, skip, impl="plain")
    assert torch.equal(got.isnan(), want.isnan()) and got[0, 3, :16].isnan().all()
    keep = ~want.isnan()
    _equal(got[keep], want[keep])


@pytest.mark.parametrize("c1", [0, 256], ids=["no_skip", "skip"])
def test_interp_fp_is_one_device_operation(dev, c1):
    """``three_interpolate_fp`` on the card is its kernel alone: no weight
    arithmetic, cast or concat (``torch.profiler``'s device events a
    call)."""
    from gspn_tpu_torch.utils.time_kernels import device_launches

    args = _fp_case(dev, 8, 64, 16, 512, c1)
    assert device_launches(lambda: ops.three_interpolate_fp(*args), 5) == 1.0


@pytest.mark.parametrize("c1", [0, 64], ids=["no_skip", "skip"])
def test_interp_fp_backward(dev, c1):
    """The fused backward (the weights recomputed from the distances, the
    index_add kernel) bitwise the plain route's, in ``points2``, ``dist``
    and ``points1``."""
    pts, idx, dist, skip = _fp_case(dev, 8, 1024, 256, 256, c1)
    gen = torch.Generator().manual_seed(5)
    gout = torch.randn((8, 1024, 256 + c1), generator=gen).to(dev)
    grads = []
    for impl in ("cuda", "plain"):
        leaves = [pts.clone().requires_grad_(True), dist.clone().requires_grad_(True)]
        if skip is not None:
            leaves.append(skip.clone().requires_grad_(True))
        out = ops.three_interpolate_fp(leaves[0], idx, leaves[1],
                                       leaves[2] if skip is not None else None, impl=impl)
        (out * gout).sum().backward()
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads, strict=True):
        _equal(got, want)


@pytest.mark.parametrize("b,n,m,c2", [(8, 8192, 1024, 128), (1, 65536, 1024, 128),
                                       (8, 1024, 256, 256)],
                         ids=["fp4", "fp4_whole_scene", "fp3"])
def test_interp_fp_kernel_rgb_skip(dev, b, n, m, c2):
    """``feature_dim=3``: FP4's skip rows are the scene's RGB (C1 = 3, the
    kernel's scalar skip loads), so FP4 takes the direct form where
    without a skip it takes the staged one; both forms at FP4's shape,
    bitwise the plain version."""
    pts, idx, dist, skip = _fp_case(dev, b, n, m, c2, 3)
    assert tinterp.interp_mm_plan(b, n, m, c2, 3)[2] == 0  # direct
    if n >= tinterp.INTERP_MM_STAGE_ROWS:  # without the skip: the staged form
        assert tinterp.interp_mm_plan(b, n, m, c2, 0)[2] == 32
    _fp_equal(dev, pts, idx, dist, skip)
    _fp_equal(dev, pts, idx, dist, None)


@pytest.mark.parametrize("c1", [0, 3, 64], ids=["no_skip", "rgb_skip", "skip"])
def test_interp_fp_kernel_bf16_valued_inputs(dev, c1):
    """bfloat16 MLPs hand the FP module bfloat16 sources and skip rows; the
    module casts them to float32 (exact) before the launch. The kernel on
    those float32 values is bitwise the plain version, and the module's
    kernel path equals its plain path on bfloat16 inputs."""
    from gspn_tpu_torch.nn.pointnet2 import PointNetFPModule

    pts, idx, dist, skip = _fp_case(dev, 8, 1024, 256, 64, c1)
    pts16 = pts.bfloat16()
    skip16 = None if skip is None else skip.bfloat16()
    _fp_equal(dev, pts16.float(), idx, dist, None if skip16 is None else skip16.float())
    gen = torch.Generator().manual_seed(3)
    xyz1 = torch.rand((8, 1024, 3), generator=gen).to(dev)
    xyz2 = torch.rand((8, 256, 3), generator=gen).to(dev)
    outs, state = [], None
    for impl in ("cuda", "plain"):
        fp = PointNetFPModule(64 + c1, (32,), ops_impl=impl, dtype=torch.bfloat16).to(dev)
        if state is None:
            state = fp.state_dict()
        fp.load_state_dict(state)
        before = tinterp.MM_KERNEL.launches
        outs.append(fp.eval()(xyz1, xyz2, skip16, pts16))
        assert tinterp.MM_KERNEL.launches == before + (impl == "cuda")
    assert outs[0].dtype == torch.bfloat16
    _equal(*outs)


# sample offsets from the origin at a squared distance below, exactly at
# and above 3e10 in float32, with every product and sum exact: 64 x (a, b,
# c) with a^2 + b^2 + c^2 = 7324218, 7324219 and 7324221
_FAR = ((173120.0, 4288.0, 3328.0), (172992.0, 8256.0, 2368.0), (173056.0, 6848.0, 2176.0))


def _projection(dev, b, n, r, s, seed=5, far=False):
    """Scenes, RoI samples about scene points on a 1 cm grid (equal
    distances), duplicated sample coordinates with other logits, RoI 0
    with no valid sample, boxes. ``far``: scene point 0 at the origin and
    every RoI's samples about 2e5 away, the first invalid and the second
    at ``_FAR[q % 3]`` from the origin (the others beyond 3e10), so that
    the 3e10 an invalid sample sits at decides the nearest valid sample's
    logit there; the boxes about the origin."""
    xyz, valid = _scenes(dev, b, n, seed=seed)
    xyz = torch.round(xyz * 100) / 100
    gen = torch.Generator().manual_seed(seed)
    pick = torch.randint(0, n, (b, r, s), generator=gen).to(dev)
    samp = torch.gather(xyz, 1, pick.reshape(b, r * s, 1).expand(-1, -1, 3)).reshape(b, r, s, 3)
    samp[:, :, 1] = samp[:, :, 0]
    logits = torch.randn((b, r, s), generator=gen).to(dev)
    svalid = (torch.rand((b, r, s), generator=gen) > 0.2).to(dev)
    svalid[:, 0] = False  # a RoI with no valid sample
    half = (torch.rand((b, r, 3), generator=gen) * 0.5 + 0.1).to(dev)
    centre = samp[:, :, 0]
    if far:
        xyz[:, 0] = 0.0
        samp = samp + torch.tensor([1.8e5, 0.0, 0.0], device=dev)  # all beyond 3e10
        samp[:, :, 1] = torch.tensor(_FAR, device=dev).repeat(r // 3 + 1, 1)[:r]
        svalid[:, 1:, 0] = False
        svalid[:, 1:, 1] = True
        centre = torch.zeros_like(centre)
    boxes = torch.cat([centre - half, centre + half], dim=-1)
    return xyz, valid, samp, logits, svalid, boxes


# (B, N, R, S, far): the main path's shapes; N, R and S off the kernel's
# blocks (512 points and 2 RoIs a CTA; samples staged 64 at a time, padded
# to 8); samples about 3e10 from a scene point
_PROJECTION_CASES = [
    (8, 8192, 64, 64, False), (1, 65536, 64, 64, False), (2, 300, 5, 70, False),
    (3, 1000, 13, 67, False), (1, 513, 9, 5, False), (2, 2048, 24, 64, True),
    (1, 1000, 13, 130, True),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,r,s,far", _PROJECTION_CASES)
def test_mask_project_kernel(dev, b, n, r, s, far, masked):
    """Bitwise its plain version: ties, a RoI with no valid sample, ragged
    blocks; ``far`` and masked: below, at and beyond 3e10 at the origin."""
    xyz, _, samp, logits, svalid, _ = _projection(dev, b, n, r, s, far=far)
    v = svalid if masked else None
    before = tmask.KERNEL.launches
    got = ops.nearest_sample_logit(xyz, samp, logits, v)  # "auto": the kernel
    want = ops.nearest_sample_logit(xyz, samp, logits, v, impl="plain")
    torch.cuda.synchronize()
    assert tmask.KERNEL.launches == before + 1
    _equal(got, want)
    if far and masked:  # at the origin, RoIs 1, 2, 3: the valid sample at, beyond, below 3e10
        _equal(got[:, [1, 3], 0], logits[:, [1, 3], 1])
        assert (got[:, 2, 0] == tmask.NEG).all()
        assert (got[:, 0] == tmask.NEG).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "b,n,r,s,far,tiling",
    [case + ({},) for case in _PROJECTION_CASES]
    + [(2, 300, 13, 6, False, dict(roi_block=8, tile_n=128)),
       (2, 1000, 13, 130, True, dict(roi_block=8, tile_n=128))],
)
def test_mask_project_boxed_kernel(dev, b, n, r, s, far, tiling, masked):
    """On the Morton-sorted scenes, as the pipeline calls it: bitwise the
    plain version everywhere, the fill included, and the dense logit at
    every valid point inside a box."""
    xyz, valid, samp, logits, svalid, boxes = _projection(dev, b, n, r, s, far=far)
    sxyz, svld, _ = ops.spatial_sorted_view(xyz, valid if masked else None)
    v = svalid if masked else None
    before = tmask.BOXED_KERNEL.launches
    got = ops.nearest_sample_logit_boxed(sxyz, samp, logits, boxes, v, svld, **tiling)
    want = ops.nearest_sample_logit_boxed(sxyz, samp, logits, boxes, v, svld, impl="plain",
                                          **tiling)
    torch.cuda.synchronize()
    assert tmask.BOXED_KERNEL.launches == before + 1
    _equal(got, want)
    dense = ops.nearest_sample_logit(sxyz, samp, logits, v, impl="plain")
    inside = ops.box_contains(boxes, sxyz, svld)
    assert inside.any()
    _equal(got[inside], dense[inside])


def _nn_case(dev, b, n, m, seed=7):
    """Targets, sources whose second half repeats the first (ties go to the
    lower index), and a source mask with row 0 fully padded."""
    gen = torch.Generator().manual_seed(seed)
    tgt = (torch.rand((b, n, 3), generator=gen) * 2).to(dev)
    src = torch.rand((b, (m + 1) // 2, 3), generator=gen) * 2
    src = torch.cat([src, src], dim=1)[:, :m].to(dev)
    valid = (torch.rand((b, m), generator=gen) > 0.3).to(dev)
    valid[0] = False
    return tgt, src, valid


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,m", [(256, 256, 256), (16, 4096, 4096), (3, 100, 7), (2, 5, 3000),
                                   (2, 600, 300)])  # N over several CTAs, not a multiple of 256
def test_nn_argmin_kernel(dev, b, n, m, masked):
    """The one-direction form: bitwise its plain version (the chamfer step's
    256 x 256 <- 256, 4096 sources over 16 tiles, ragged sizes); a fully
    padded row gets index 0."""
    tgt, src, valid = _nn_case(dev, b, n, m)
    v = valid if masked else None
    before = tchamfer.KERNEL.launches
    got = ops.nn_argmin(tgt, src, v, impl="cuda")
    torch.cuda.synchronize()
    assert tchamfer.KERNEL.launches == before + 1
    _equal(got, ops.nn_argmin(tgt, src, v, impl="plain"))
    if masked:
        assert not got[0].any()


def _pair_equal(dev, b, n, m, mask1, mask2, ctas=None):
    """The two-way kernel in one launch, bitwise the plain version each way;
    masked, a row whose candidates are all invalid gets index 0 each way
    (sources of scene 0, targets of scene 1)."""
    tgt, src, valid2 = _nn_case(dev, b, n, m)
    gen = torch.Generator().manual_seed(11)
    valid1 = (torch.rand((b, n), generator=gen) > 0.3).to(dev)
    valid1[min(1, b - 1)] = False
    v1, v2 = (valid1 if mask1 else None), (valid2 if mask2 else None)
    before = tchamfer.KERNEL.launches
    if ctas is None:
        got = ops.nn_argmin_pair(tgt, src, v1, v2, impl="cuda")
    else:
        got = tchamfer._argmin_cuda(tgt, src, v1, v2, both=True, ctas=ctas)
    torch.cuda.synchronize()
    assert tchamfer.KERNEL.launches == before + 1
    want = ops.nn_argmin_pair(tgt, src, v1, v2, impl="plain")
    for g, w in zip(got, want, strict=True):
        _equal(g, w)
    if mask2:
        assert not got[0][0].any()
    if mask1:
        assert not got[1][min(1, b - 1)].any()


@pytest.mark.parametrize("mask2", [False, True])
@pytest.mark.parametrize("mask1", [False, True])
@pytest.mark.parametrize("b,n,m", [
    (256, 256, 256),  # slice (G)'s chamfer: a CTA a row
    (16, 4096, 4096),  # ties, 16 tiles of sources, 16 CTAs a row
    (3, 100, 7), (2, 5, 3000), (1, 300, 5000),
    (4, 600, 1000),  # 3 CTAs a row, the last CTA's targets past N
    (2, 2500, 300),  # 10 target tiles, 10 CTAs a row
    (1, 4500, 600),  # 18 target tiles: 16 CTAs, two of 2 passes, the last partly filled
])
def test_nn_argmin_pair_kernel(dev, b, n, m, mask1, mask2):
    _pair_equal(dev, b, n, m, mask1, mask2)


@pytest.mark.parametrize("ctas", [1, 2, 3, 4, 5])
def test_nn_argmin_pair_kernel_at_every_cluster_size(dev, ctas):
    """1100 targets (5 tiles) at every count of CTAs a row: 5 passes, 3
    and 2, 2 and 1, one CTA of 2 passes, and a tile a CTA; the column
    minima carried across a CTA's passes."""
    _pair_equal(dev, 3, 1100, 700, True, True, ctas=ctas)


def test_nn_argmin_pair_kernel_refuses_bad_clusters(dev):
    """No CTA a row, more than 16, or more than the row's tiles."""
    tgt, src, _ = _nn_case(dev, 1, 600, 50)
    for ctas in (0, 4, 17):
        with pytest.raises(RuntimeError, match="nn_argmin failed to launch"):
            tchamfer._argmin_cuda(tgt, src, None, None, both=True, ctas=ctas)
    big, _, _ = _nn_case(dev, 1, 5000, 50)
    with pytest.raises(RuntimeError, match="nn_argmin failed to launch"):
        tchamfer._argmin_cuda(big, src, None, None, both=True, ctas=17)


def test_nn_argmin_pair_kernel_leaves_its_counts_zero(dev):
    """Every launch of rows over several CTAs leaves the rows' counts zero,
    so the calls after it stay right, on the same stream and on another."""
    for mask1 in (True, False, True):
        _pair_equal(dev, 4, 1100, 700, mask1, True)
    with torch.cuda.stream(torch.cuda.Stream()):
        _pair_equal(dev, 4, 1100, 700, False, False)
    torch.cuda.synchronize()
    assert len(tchamfer._DONE) >= 2
    assert not any(counts.any() for counts in tchamfer._DONE.values())


@pytest.mark.parametrize("b,n,m", [(256, 256, 256), (16, 4096, 4096)])
def test_nn_argmin_pair_is_one_device_operation(dev, b, n, m):
    """Both chamfer argmins are the kernel alone, one launch, no fill of
    the outputs or the scratch (``torch.profiler``'s device events)."""
    from gspn_tpu_torch.utils.time_kernels import device_launches

    tgt, src, valid = _nn_case(dev, b, n, m)
    assert device_launches(lambda: ops.nn_argmin_pair(tgt, src, None, valid), 5) == 1.0


def _index_add_case(b, m, n, c, layout="third"):
    """``(src, idx)`` on the CPU: "third" puts a third of the positions on
    one index (the rest random, rows left empty), "one" every position,
    "sparse" every 100,000th position in the first 256 rows and the rest
    above them."""
    gen = torch.Generator().manual_seed(8)
    src = torch.randn((b, m, c), generator=gen)
    idx = torch.randint(0, n, (b, m), generator=gen, dtype=torch.int32)
    if layout == "one":
        idx[:] = n - 1
    elif layout == "sparse":
        idx = torch.randint(256, n, (b, m), generator=gen, dtype=torch.int32)
        idx[:, ::100_000] = torch.randint(0, 256, (b, -(-m // 100_000)), generator=gen,
                                          dtype=torch.int32)
    else:
        idx[:, ::3] = idx[:, :1]
    return src, idx


def _index_add_equal(dev, src, idx, n, plan=None):
    """The kernel (at ``plan``, or the wrapper's) in one launch, bitwise
    its plain version and the CPU's scatter_add (ascending positions from
    +0.0)."""
    b, m, c = src.shape
    before = tgroup.KERNEL.launches
    if plan is None:
        got = ops.index_add_rows(src.to(dev), idx.to(dev), n, impl="cuda")
    else:
        got = tgroup._index_add_cuda(src.to(dev), idx.to(dev), n, plan=plan)
    torch.cuda.synchronize()
    assert tgroup.KERNEL.launches == before + 1
    _equal(got, ops.index_add_rows(src.to(dev), idx.to(dev), n, impl="plain"))
    want = torch.zeros((b, n, c)).scatter_add_(1, idx.long()[..., None].expand(b, m, c), src)
    _equal(got.cpu(), want)


@pytest.mark.parametrize("b,m,n,c,layout", [
    (256, 256, 256, 3, "third"),  # (G)'s chamfer backward: one row tile
    (8, 24576, 1024, 128, "third"),  # FP4's backward at the flagship: 32 row tiles, 3 steps
    (4, 5120, 4096, 128, "third"),  # (I)'s RoIAlign backward
    (16, 4096, 8, 64, "third"),  # 512 positions on each index
    (3, 7, 50, 5, "third"),
    (1, 4096, 70000, 8, "third"),  # n beyond one CTA's rows: 274 row tiles
    (3, 1001, 300, 7, "third"),  # M not a multiple of 32 (nor of 4: scalar index loads)
    (2, 3000, 40, 12, "one"),  # a row of all one index: one chain of 3000 adds
    (1, 65536, 1024, 3, "third"),  # B = 1, M = 65536: 8 steps
    (4, 0, 16, 4, "third"),  # M = 0: zeros, written by the kernel
    # the first CTA's rows take one position in 100,000: a short list over
    # more than 2^23 positions (a kept position's offset bits), sorted
    # before its offsets overflow
    (1, 9_000_000, 4096, 1, "sparse"),
])
def test_index_add_kernel(dev, b, m, n, c, layout):
    """Bitwise its plain version and the CPU's scatter_add at the wrapper's
    plan, with many positions on one index and empty rows."""
    _index_add_equal(dev, *_index_add_case(b, m, n, c, layout), n)


@pytest.mark.parametrize("b,m,n,c,plan", [
    (3, 9000, 300, 16, (16, 16)),  # 2 steps, 19 row tiles
    (1, 80000, 64, 4, (8, 4)),  # 10 steps: lists sorted before the row ends
    (2, 3000, 50, 16, (7, 8)),  # channel tiles of 8 (float4 loads), ragged rows
    (2, 3000, 50, 10, (5, 4)),  # channel tiles of 4 but C % 4 != 0 (scalar loads)
    (2, 1001, 50, 12, (1, 12)),  # one row a CTA
    (2, 2048, 600, 3, (256, 3)),  # the most rows a CTA
    (1, 4096, 8, 8192, (1, 8192)),  # the most sums a CTA
    (1, 20000, 4, 4, (4, 4)),  # every position in the CTA's rows: full lists
])
def test_index_add_kernel_at_any_plan(dev, b, m, n, c, plan):
    """The kernel's tilings: row tiles that do not divide n, channel tiles
    with vector or scalar loads, several steps and lists, the plan's
    limits."""
    _index_add_equal(dev, *_index_add_case(b, m, n, c), n, plan=plan)


def test_index_add_kernel_refuses_plans_beyond_its_limits(dev):
    src, idx = (t.to(dev) for t in _index_add_case(2, 64, 8, 4))
    for plan in ((257, 1), (0, 4), (8, 2048), (1, 8193)):
        with pytest.raises(RuntimeError, match="index_add failed to launch"):
            tgroup._index_add_cuda(src, idx, 8, plan=plan)


@pytest.mark.parametrize("b,m,n,c", [(256, 256, 256, 3), (8, 24576, 1024, 128)])
def test_index_add_kernel_is_one_device_operation(dev, b, m, n, c):
    """``index_add_rows`` on the card is its kernel alone: no sort, cast or
    zero fill (``torch.profiler``'s device events a call)."""
    from gspn_tpu_torch.utils.time_kernels import device_launches

    src, idx = (t.to(dev) for t in _index_add_case(b, m, n, c))
    assert device_launches(lambda: ops.index_add_rows(src, idx, n), 5) == 1.0


def test_gather_point_backward_launches_the_kernel(dev):
    """``gather_point``'s backward on the card is the index_add kernel,
    bitwise the CPU's gradient."""
    gen = torch.Generator().manual_seed(9)
    pts = torch.randn((4, 100, 6), generator=gen)
    idx = torch.randint(0, 100, (4, 300), generator=gen, dtype=torch.int32)
    g = torch.randn((4, 300, 6), generator=gen)
    grads = []
    for d in (dev, torch.device("cpu")):
        p = pts.to(d).requires_grad_(True)
        before = tgroup.KERNEL.launches
        (ops.gather_point(p, idx.to(d)) * g.to(d)).sum().backward()
        assert tgroup.KERNEL.launches == before + (d.type == "cuda")
        grads.append(p.grad.cpu())
    _equal(*grads)


@pytest.mark.parametrize("b,m,n,c", [(4, 300, 100, 6), (4, 5120, 4096, 128)],
                         ids=["small", "roi_align"])
def test_gather_point_backward_bf16_gradient(dev, b, m, n, c):
    """A bfloat16 gather's gradient (a bfloat16 MLP's SA grouping or RoI
    gather) on the card: summed by the index_add kernel in float32 (the
    wrapper's cast) and rounded once, bitwise the CPU's; it launches the
    kernel and never the plain version."""
    gen = torch.Generator().manual_seed(9)
    pts = torch.randn((b, n, c), generator=gen).bfloat16()
    idx = torch.randint(0, n, (b, m), generator=gen, dtype=torch.int32)
    g = torch.randn((b, m, c), generator=gen).bfloat16()
    grads = []
    for d in (dev, torch.device("cpu")):
        p = pts.to(d).requires_grad_(True)
        before = tgroup.KERNEL.launches
        ops.gather_point(p, idx.to(d)).backward(g.to(d))
        assert tgroup.KERNEL.launches == before + (d.type == "cuda")
        assert p.grad.dtype == torch.bfloat16
        grads.append(p.grad.cpu())
    _equal(*grads)
    _equal(grads[0], ops.index_add_rows(g.float(), idx, n, impl="plain").bfloat16())
    with pytest.raises(ValueError, match="float32"):  # the kernel itself takes float32 only
        tgroup._index_add_cuda(g.to(dev), idx.to(dev), n)


def test_nn_distance_auto_launches_the_kernel(dev):
    tgt, src, valid = _nn_case(dev, 256, 256, 256)
    before = tchamfer.KERNEL.launches
    got = ops.nn_distance(tgt, src, valid2=valid)
    torch.cuda.synchronize()
    assert tchamfer.KERNEL.launches == before + 1  # both argmins in one launch
    want = ops.nn_distance(tgt, src, valid2=valid, impl="plain")
    assert tchamfer.KERNEL.launches == before + 1
    for x, y in zip(got, want, strict=True):
        _equal(x, y)


# the fused training BatchNorm at the training cells' shapes: stage 1's
# largest crop (16 x 64 seeds x K 256 rows, C 256, unmasked), stage 2's SA1
# (32 x 1024 centres x K 32 rows, C 32) and the recognition encoder (16 x
# 64 seeds x 256 GT points, C 64, masked by the GT's validity)
BN_SHAPES = [(262144, 256, False), (1048576, 32, False), (262144, 64, True)]
BN_IDS = ["crop_k256_c256", "sa1_c32", "recog_c64_masked"]
BN_KERNELS = ("bn_stats", "bn_apply", "bn_grad_terms", "bn_grad_input")


def _bn_case(dev, rows, c, masked, seed=0):
    """A Dense output's scale: channels of means 0-2 and spreads 0.5-2.5;
    scale and bias as Adam leaves them after a few steps; the output's
    gradient."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mu = 2.0 * torch.rand(c, generator=gen, device=dev)
    sd = 0.5 + 2.0 * torch.rand(c, generator=gen, device=dev)
    x = torch.randn((rows, c), generator=gen, device=dev) * sd + mu
    mask = torch.rand(rows, generator=gen, device=dev) > 0.3 if masked else None
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    bias = 0.1 * torch.randn(c, generator=gen, device=dev)
    g = torch.randn((rows, c), generator=gen, device=dev) * 1e-3
    return x, mask, scale, bias, g


def _launched(fn):
    before = ops.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c - before[k] for k, c in ops.launch_counts().items() if c != before[k]}


def _running(c, dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    return (torch.randn(c, generator=gen, device=dev), torch.rand(c, generator=gen, device=dev))


@pytest.mark.parametrize("rows,c,masked", BN_SHAPES, ids=BN_IDS)
def test_bn_stats_kernel(dev, rows, c, masked):
    """The statistics, one launch of the kernel after PyTorch's column sums:
    mean, rstd, the clamp's gate, tot and the blended running statistics
    bitwise the plain version (the module's code); ``update=False`` leaves
    the running statistics alone."""
    x, mask, _, _, _ = _bn_case(dev, rows, c, masked)
    got_run, want_run = _running(c, dev), _running(c, dev)
    stats, launched = _launched(lambda: ops.batch_norm_stats(
        x, mask, *got_run, eps=1e-3, momentum=0.9, impl="cuda"))
    assert launched == {"bn_stats": 1}
    _equal(stats, ops.batch_norm_stats(x, mask, *want_run, eps=1e-3, momentum=0.9,
                                       impl="plain"))
    for a, b in zip(got_run, want_run, strict=True):
        _equal(a, b)
    held = tuple(t.clone() for t in got_run)
    _equal(ops.batch_norm_stats(x, mask, *held, eps=1e-3, momentum=0.9, update=False,
                                impl="cuda"), stats)
    for a, b in zip(held, got_run, strict=True):
        _equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
@pytest.mark.parametrize("rows,c,masked", BN_SHAPES, ids=BN_IDS)
def test_bn_apply_kernel_bitwise(dev, rows, c, masked, relu, dtype):
    """The normalization kernel, one launch, bitwise the plain version (the
    module's chain of ops) given the same statistics."""
    x, mask, scale, bias, _ = _bn_case(dev, rows, c, masked)
    stats = ops.batch_norm_stats(x, mask, *_running(c, dev), eps=1e-3, momentum=0.9,
                                 impl="plain")
    got, launched = _launched(lambda: ops.batch_norm_apply(
        x, stats, scale, bias, relu=relu, dtype=dtype, impl="cuda"))
    assert launched == {"bn_apply": 1}
    _equal(got, ops.batch_norm_apply(x, stats, scale, bias, relu=relu, dtype=dtype,
                                     impl="plain"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
@pytest.mark.parametrize("rows,c,masked", BN_SHAPES, ids=BN_IDS)
def test_bn_backward_kernels(dev, rows, c, masked, relu, dtype):
    """The backward's two kernels, one launch each, bitwise the plain
    versions: the ReLU's gradient and the three terms autograd reduces,
    then ``dx`` from their column sums."""
    x, mask, scale, bias, g = _bn_case(dev, rows, c, masked)
    g = g.to(dtype)
    stats = ops.batch_norm_stats(x, mask, *_running(c, dev), eps=1e-3, momentum=0.9,
                                 impl="plain")
    got, launched = _launched(lambda: ops.batch_norm_grad_terms(
        x, g, stats, scale, bias, relu=relu, impl="cuda"))
    assert launched == {"bn_grad_terms": 1}
    want = ops.batch_norm_grad_terms(x, g, stats, scale, bias, relu=relu, impl="plain")
    for a, b in zip(got, want, strict=True):
        _equal(a, b)
    sums = (got[2].sum(0), got[3].sum(0))
    dx, launched = _launched(lambda: ops.batch_norm_grad_input(
        x, got[3], mask, stats, *sums, impl="cuda"))
    assert launched == {"bn_grad_input": 1}
    _equal(dx, ops.batch_norm_grad_input(x, got[3], mask, stats, *sums, impl="plain"))


def test_bn_kernels_take_odd_widths_and_float_weights(dev):
    """C not a multiple of 4 (one channel a thread), an unaligned input, a
    float row weight and all rows masked out: every kernel bitwise its
    plain version."""
    gen = torch.Generator(device=dev).manual_seed(3)
    base = torch.randn((1001 * 37 + 1,), generator=gen, device=dev)
    x = base[1:].view(1001, 37)  # 4 bytes past an aligned start
    scale, bias = torch.rand(37, device=dev) + 0.5, torch.randn(37, device=dev)
    g = torch.randn((1001, 37), generator=gen, device=dev)
    for mask in (None, torch.rand(1001, generator=gen, device=dev),
                 torch.zeros(1001, dtype=torch.bool, device=dev)):
        stats = ops.batch_norm_stats(x, mask, *_running(37, dev), eps=1e-3, momentum=0.9,
                                     impl="cuda")
        _equal(stats, ops.batch_norm_stats(x, mask, *_running(37, dev), eps=1e-3, momentum=0.9,
                                           impl="plain"))
        _equal(ops.batch_norm_apply(x, stats, scale, bias, relu=True, impl="cuda"),
               ops.batch_norm_apply(x, stats, scale, bias, relu=True, impl="plain"))
        terms = ops.batch_norm_grad_terms(x, g, stats, scale, bias, relu=True, impl="cuda")
        for a, b in zip(terms, ops.batch_norm_grad_terms(x, g, stats, scale, bias, relu=True,
                                                         impl="plain"), strict=True):
            _equal(a, b)
        sums = (terms[2].sum(0), terms[3].sum(0))
        _equal(ops.batch_norm_grad_input(x, terms[3], mask, stats, *sums, impl="cuda"),
               ops.batch_norm_grad_input(x, terms[3], mask, stats, *sums, impl="plain"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_point_mlp_takes_the_kernels_in_training_only(dev, dtype):
    """A PointMLP in training mode on the card: four kernel launches a
    BatchNorm layer and step (statistics and normalization forward, the
    two backward passes), output, gradients and running statistics bitwise
    the module's own code (``ops_impl="plain"``), which launches none; in
    eval mode none either."""
    from gspn_tpu_torch.nn.layers import PointMLP

    torch.manual_seed(0)
    mlp = PointMLP(3, (32, 64, 128), dtype=dtype).to(dev).train()
    plain = PointMLP(3, (32, 64, 128), dtype=dtype, ops_impl="plain").to(dev).train()
    plain.load_state_dict(mlp.state_dict())
    x = torch.randn((4, 256, 64, 3), device=dev)
    mask = torch.rand((4, 256, 64), device=dev) > 0.2
    runs = []
    for m in (mlp, plain):
        out, launched = _launched(lambda m=m: m(x, mask).float().square().mean().backward())
        runs.append((launched, {k: p.grad for k, p in m.named_parameters()}))
    (launched, grads), (plaunched, pgrads) = runs
    assert launched == {k: 3 for k in BN_KERNELS} and not plaunched
    for k in grads:
        _equal(grads[k], pgrads[k])
    for k, v in mlp.state_dict().items():
        _equal(v, plain.state_dict()[k])
    with torch.no_grad():
        _equal(mlp(x, mask), plain(x, mask))  # held alike: both blend once more
    _, launched = _launched(lambda: mlp.eval()(x, mask))
    assert not launched


def _step_equal(got: dict, want: dict, grads: dict, pgrads: dict) -> None:
    """A training step's kernel path bitwise its plain path: the loss, its
    terms and every gradient."""
    for k in want:
        _equal(got[k], want[k])
    for k in pgrads:
        _equal(grads[k], pgrads[k])


# the BatchNorm layers a training step normalizes on the kernels: stage 1's
# center_enc, ctx_enc_0-2 and recog_enc (3 each); stage 2's SA1-SA4 (3
# each), FP1-FP4 (2, 2, 2, 3), roi_mlp and mask_mlp (2 each)
BN_LAYERS = {1: 15, 2: 25}


def _with_bn(launches: dict, stage: int) -> dict:
    return {**launches, **{k: BN_LAYERS[stage] for k in BN_KERNELS}}


def test_train_step_kernel_path_matches_plain_path(dev):
    """One GSPN training step at full width on the slice's batch: the loss,
    its terms and the gradients bitwise equal (the kernels are bitwise,
    the BatchNorm's among them, the rest is the same PyTorch, and every
    sum is taken in a fixed order)."""
    bench_slice.pin_float32_matmuls()
    cfg = bench_slice.train_config()
    batch = bench_slice.train_batch(dev)
    model = bench_slice.seeded_gspn(cfg, dev)
    _, pmodel = bench_slice.plain_gspn(cfg, model)
    eps = torch.randn((4, 64, cfg.latent_dim), generator=torch.Generator().manual_seed(1)).to(dev)
    step = tsteps.make_train_step(tsteps.make_gspn_loss_fn(64, 256))
    runs = []
    for m in (model, pmodel):
        before = ops.launch_counts()
        state = tsteps.TrainState(m, tsteps.make_optimizer(m, 1e-3))
        metrics = step(state, batch, z_eps=eps)
        torch.cuda.synchronize()
        launched = {k: c - before[k] for k, c in ops.launch_counts().items() if c != before[k]}
        runs.append((metrics, {k: p.grad for k, p in m.named_parameters()}, launched))
    (got, grads, launched), (want, pgrads, plain_launched) = runs
    assert launched == _with_bn({"fps": 1, "ball_group": 1, "nn_argmin": 1, "index_add": 1}, 1)
    assert not plain_launched
    _step_equal(got, want, grads, pgrads)


def test_train_steps_are_bitwise_reproducible(dev):
    """Two kernel-path runs of three GSPN training steps at full width from
    the same weights: losses, gradients, parameters and running statistics
    bitwise equal (every sum is taken in a fixed order)."""
    bench_slice.pin_float32_matmuls()
    cfg = bench_slice.train_config()
    batch = bench_slice.train_batch(dev)
    eps = torch.randn((4, 64, cfg.latent_dim), generator=torch.Generator().manual_seed(1)).to(dev)
    step = tsteps.make_train_step(tsteps.make_gspn_loss_fn(64, 256))
    runs = []
    for _ in range(2):
        m = bench_slice.seeded_gspn(cfg, dev)
        state = tsteps.TrainState(m, tsteps.make_optimizer(m, 1e-3))
        losses = torch.stack([step(state, batch, z_eps=eps)["loss"] for _ in range(3)])
        runs.append((losses, {k: p.grad.clone() for k, p in m.named_parameters()},
                     m.state_dict()))
    (la, ga, sa), (lb, gb, sb) = runs
    _equal(la, lb)
    for k in ga:
        _equal(ga[k], gb[k])
    for k in sa:
        _equal(sa[k], sb[k])


def _stage2_small(dev):
    """A small stage-2 step's inputs at full width: B=2 x N=2048 scenes, the
    frozen GSPN and R-PointNet seeded, their plain twins, and its noise."""
    bench_slice.pin_float32_matmuls()
    gcfg, rcfg = bench_slice.stage2_configs()
    batch = bench_slice.train_batch(dev, b=2, n=2048)
    gmodel = bench_slice.seeded_frozen_gspn(gcfg, dev)
    gen = torch.Generator().manual_seed(1)
    draws = {"box_noise": torch.randn((2, bench_slice.STAGE2_INSTANCES, 6), generator=gen).to(dev),
             "z_eps": torch.randn((2, 64, gcfg.latent_dim), generator=gen).to(dev)}
    return gcfg, rcfg, batch, gmodel, draws


def _stage2_step(gmodel):
    return tsteps.make_train_step(tsteps.make_rpointnet_loss_fn(
        bench_slice.STAGE2_INSTANCES, (gmodel, bench_slice.TRAIN_SEEDS)))


def test_stage2_step_kernel_path_matches_plain_path(dev):
    """One R-PointNet stage-2 step over a frozen GSPN's proposals: the loss,
    its terms and every gradient bitwise equal to the plain path's (the
    kernels are bitwise and every gather backward adds in a fixed order),
    the kernel path's launches one step's, the plain path's none."""
    gcfg, rcfg, batch, gmodel, draws = _stage2_small(dev)
    model = bench_slice.seeded_rpointnet(rcfg, dev)
    _, pmodel = bench_slice.plain_rpointnet(rcfg, model)
    _, pgmodel = bench_slice.plain_gspn(gcfg, gmodel)
    runs = []
    for m, g in ((model, gmodel), (pmodel, pgmodel)):
        before = ops.launch_counts()
        state = tsteps.TrainState(m, tsteps.make_optimizer(m, 1e-3))
        metrics = _stage2_step(g)(state, batch, **draws)
        torch.cuda.synchronize()
        launched = {k: c - before[k] for k, c in ops.launch_counts().items() if c != before[k]}
        runs.append((metrics, {k: p.grad for k, p in m.named_parameters()}, launched))
    (got, grads, launched), (want, pgrads, plain_launched) = runs
    assert launched == _with_bn(bench_slice.STAGE2_PER_STEP, 2)
    assert not plain_launched
    assert got["num_fg"].item() > 0
    _step_equal(got, want, grads, pgrads)


def test_stage2_steps_are_bitwise_reproducible(dev):
    """Two kernel-path runs of three stage-2 steps from the same weights:
    losses, gradients, parameters and running statistics bitwise equal."""
    _, rcfg, batch, gmodel, draws = _stage2_small(dev)
    runs = []
    for _ in range(2):
        m = bench_slice.seeded_rpointnet(rcfg, dev)
        state = tsteps.TrainState(m, tsteps.make_optimizer(m, 1e-3))
        losses = torch.stack([_stage2_step(gmodel)(state, batch, **draws)["loss"]
                              for _ in range(3)])
        runs.append((losses, {k: p.grad.clone() for k, p in m.named_parameters()},
                     m.state_dict()))
    (la, ga, sa), (lb, gb, sb) = runs
    _equal(la, lb)
    for k in ga:
        _equal(ga[k], gb[k])
    for k in sa:
        _equal(sa[k], sb[k])


def test_plain_fp_backward_launches_no_kernel(dev):
    """A plain FP module's backward on CUDA tensors takes its gather
    backward on the plain route: no kernel launch (the "exact"
    interpolation's ``group_point`` gets the module's ``ops_impl``)."""
    from gspn_tpu_torch.nn.pointnet2 import PointNetFPModule

    gen = torch.Generator().manual_seed(0)
    fp = PointNetFPModule(64 + 32, (48,), ops_impl="plain").to(dev).train()
    xyz1 = torch.rand((2, 512, 3), generator=gen).to(dev)
    xyz2 = torch.rand((2, 128, 3), generator=gen).to(dev)
    p1 = torch.randn((2, 512, 32), generator=gen).to(dev).requires_grad_()
    p2 = torch.randn((2, 128, 64), generator=gen).to(dev).requires_grad_()
    before = ops.launch_counts()
    fp(xyz1, xyz2, p1, p2).square().sum().backward()
    torch.cuda.synchronize()
    assert ops.launch_counts() == before
    assert p2.grad.abs().sum() > 0


class _GspnOpCalls(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ``gspn::`` op calls made under it, forward and backward."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name.startswith("gspn::"):
            self.calls[name[len("gspn::"):]] = self.calls.get(name[len("gspn::"):], 0) + 1
        return func(*args, **(kwargs or {}))


# the op that launches each kernel of the training slices
_OP_OF = {"fps": "fps", "ball_group": "ball_group", "box_group": "box_group",
          "three_nn": "three_nn", "interp_mm": "three_interpolate_fp",
          "nn_argmin": "nn_argmin_pair", "index_add": "index_add_rows"}


@pytest.mark.parametrize("slice_", ["G", "I"])
def test_training_goes_through_the_registered_ops(dev, slice_):
    """A stage-1 (G) and a stage-2 (I) training step: each point kernel's
    launch is one call of its ``gspn::`` op (the BatchNorm's kernels run
    under ``batch_norm_train``'s autograd function, by no op); the plain
    path calls the same ops but the FP interpolation's (it takes the exact
    interpolation) and launches nothing; and the two paths still train
    bitwise the same (loss, terms, gradients)."""
    if slice_ == "G":
        bench_slice.pin_float32_matmuls()
        cfg = bench_slice.train_config()
        batch = bench_slice.train_batch(dev)
        model = bench_slice.seeded_gspn(cfg, dev)
        _, pmodel = bench_slice.plain_gspn(cfg, model)
        eps = torch.randn((4, 64, cfg.latent_dim), generator=torch.Generator().manual_seed(1))
        draws = {"z_eps": eps.to(dev)}
        step = tsteps.make_train_step(tsteps.make_gspn_loss_fn(64, 256))
        paths = [(model, step), (pmodel, step)]
        want_launches = _with_bn({"fps": 1, "ball_group": 1, "nn_argmin": 1, "index_add": 1},
                                 1)
    else:
        gcfg, rcfg, batch, gmodel, draws = _stage2_small(dev)
        model = bench_slice.seeded_rpointnet(rcfg, dev)
        _, pmodel = bench_slice.plain_rpointnet(rcfg, model)
        _, pgmodel = bench_slice.plain_gspn(gcfg, gmodel)
        paths = [(model, _stage2_step(gmodel)), (pmodel, _stage2_step(pgmodel))]
        want_launches = _with_bn(bench_slice.STAGE2_PER_STEP, 2)
    runs = []
    for m, step in paths:
        before = ops.launch_counts()
        state = tsteps.TrainState(m, tsteps.make_optimizer(m, 1e-3))
        with _GspnOpCalls() as calls:
            metrics = step(state, batch, **draws)
        torch.cuda.synchronize()
        launched = {k: c - before[k] for k, c in ops.launch_counts().items() if c != before[k]}
        runs.append((metrics, {k: p.grad for k, p in m.named_parameters()}, launched,
                     calls.calls))
    (got, grads, launched, op_calls), (want, pgrads, plain_launched, plain_calls) = runs
    assert launched == want_launches and not plain_launched
    want_ops = {}
    for k, c in launched.items():
        if k not in BN_KERNELS:
            want_ops[_OP_OF[k]] = want_ops.get(_OP_OF[k], 0) + c
    assert op_calls == want_ops
    assert set(plain_calls) == set(op_calls) - {"three_interpolate_fp"}
    _step_equal(got, want, grads, pgrads)


def _tiny_serving_config():
    """The trainers' ``--preset tiny`` stages at 8 seeds, thresholds inside
    the seeded weights' logit range."""
    from gspn_tpu_torch.models.pipeline import PipelineConfig
    from gspn_tpu_torch.train.train_gspn import TINY_GSPN
    from gspn_tpu_torch.train.train_rpointnet import tiny_rpointnet

    return PipelineConfig(gspn=TINY_GSPN, rpointnet=tiny_rpointnet(3), num_seeds=8,
                          score_thresh=0.0, mask_thresh=0.49)


@pytest.mark.parametrize("shape", ["tiny", "flagship"])
def test_streamed_graph_replay_equals_eager(dev, shape):
    """``make_streamed_inference_fn`` on the card (one request captured in a
    CUDA graph, replayed T times) against T eager kernel-path calls, bit
    for bit; the capture launches each kernel of a request once beside its
    warm-up, and the replays launch nothing from Python. A second call of
    the same shapes, its batches in the other order, replays the kept
    capture: no launch, each batch still its eager call's answer."""
    from gspn_tpu_torch.models import pipeline as tpl

    bench_slice.pin_float32_matmuls()
    if shape == "tiny":
        cfg, t_steps = _tiny_serving_config(), 3
        xyz, valid = _scenes(dev, 2, 512)
        xyz_s = torch.stack([xyz, xyz.flip(1), xyz * 0.9])
        valid_s = torch.stack([valid, valid.flip(1), valid])
    else:
        cfg, t_steps = bench_slice.slice_config(), 2
        xyz, valid, _ = bench_slice.request(cfg, "B8xN8192", dev, seed=1)
        xyz_s, valid_s = torch.stack([xyz, xyz * 0.9]), torch.stack([valid, valid])
    model = bench_slice.seeded_model(cfg, dev)
    eps_s = torch.randn((t_steps, xyz_s.shape[1], cfg.num_seeds, cfg.gspn.latent_dim),
                        generator=torch.Generator().manual_seed(2)).to(dev)
    infer = tpl.make_inference_fn(cfg)
    with torch.inference_mode():
        ops.reset_launch_counts()
        eager = [infer(model, xyz_s[i], valid_s[i], z_eps=eps_s[i]) for i in range(t_steps)]
        per_request = {k: c // t_steps for k, c in ops.launch_counts().items() if c}
        run = tpl.make_streamed_inference_fn(cfg)
        ops.reset_launch_counts()
        got = run(model, xyz_s, valid_s, eps_s)
        torch.cuda.synchronize()
        captured = {k: c for k, c in ops.launch_counts().items() if c}
        ops.reset_launch_counts()
        again = run(model, xyz_s.flip(0), valid_s.flip(0), eps_s.flip(0))
        torch.cuda.synchronize()
    assert captured == {k: 2 * c for k, c in per_request.items()}
    assert not any(ops.launch_counts().values())
    for i in range(t_steps):
        for f in tpl.PREDICTION_FIELDS:
            _equal(getattr(got, f)[i], getattr(eager[i], f))
            _equal(getattr(again, f)[t_steps - 1 - i], getattr(eager[i], f))
    assert not torch.equal(got.scores[0], got.scores[1])


def test_cuda_artifact_serves_bitwise_and_is_refused_on_the_cpu(dev, tmp_path):
    """A TINY artifact exported for ``cuda``: its session (the program
    replayed from a CUDA graph) equals the live kernel path with the same
    noise, and the artifact does not load on the CPU."""
    from gspn_tpu_torch.models import pipeline as tpl
    from gspn_tpu_torch.serve import export as sx
    from gspn_tpu_torch.serve import runtime as srt

    cfg = _tiny_serving_config()
    model = bench_slice.seeded_model(cfg, dev)
    path = sx.save_artifact(tmp_path / "tiny.gspnt",
                            sx.export_inference(cfg, model, 512, batch_size=2, device=dev), cfg)
    with pytest.raises(ValueError, match=r"exported for \['cuda'\]"):
        sx.load_artifact(path, "cpu")
    session = srt.InferenceSession(path, model.state_dict(), device=dev)
    xyz, valid = _scenes(dev, 3, 512)
    got = session.predict(xyz.cpu().numpy(), valid.cpu().numpy(), seed=5)
    infer = tpl.make_inference_fn(cfg)
    for ci, (lo, hi) in enumerate(((0, 2), (2, 3))):
        x, v = xyz[lo:hi], valid[lo:hi]
        if hi - lo < 2:
            x, v = torch.cat([x, x[:1]]), torch.cat([v, v[:1]])
        eps = srt.chunk_noise(5, ci, session.noise_shape).to(dev)
        with torch.inference_mode():
            want = infer(model, x, v, z_eps=eps)
        for f in tpl.PREDICTION_FIELDS:
            np.testing.assert_array_equal(got[f][lo:hi], getattr(want, f)[:hi - lo].cpu().numpy())


def test_run_eval_artifact_equals_live_on_the_card(dev, tmp_path):
    """``run_eval.main`` at ``--preset tiny --device cuda``: ``--artifact`` (a
    cuda artifact, its program replayed from a CUDA graph) gives the live
    kernel path's summary and dumps, bit for bit."""
    import contextlib
    import io
    import json

    from gspn_tpu_torch.eval import run_eval
    from gspn_tpu_torch.serve import export_serving

    common = ["--preset", "tiny", "--num-points", "512", "--num-seeds", "8", "--num-classes", "3"]
    art = export_serving.main(common + ["--batch", "2", "--out", str(tmp_path / "t.gspnt")])
    argv = common + ["--device", "cuda", "--num-scenes", "4", "--batch", "2", "--bootstrap", "8"]
    summaries = []
    for extra, dumps in (([], "live"), (["--artifact", str(art)], "served")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_eval.main(argv + extra + ["--dump-dir", str(tmp_path / dumps)])
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        summaries.append({k: v for k, v in summary.items() if k != "points_per_sec"})
    assert summaries[0] == summaries[1] and summaries[0]["scenes"] == 4
    for dump in sorted((tmp_path / "live").glob("*.npz")):
        with np.load(dump) as a, np.load(tmp_path / "served" / dump.name) as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_sanitize_cases_launch_every_kernel_bitwise(dev):
    """``utils.debug --sanitize``'s launches: every kernel once on each code
    path, each bitwise its plain version, every kernel launched."""
    from gspn_tpu_torch.utils import debug

    counts = debug.run_sanitize_cases()
    assert set(counts) == set(ops.KERNELS) and all(counts.values())


def test_plain_kernels_runs_auto_on_the_plain_versions(dev):
    """Within ``plain_kernels`` an ``impl="auto"`` op on the card launches
    no kernel and answers as its plain version; ``impl="cuda"`` still
    launches."""
    from gspn_tpu_torch.utils import debug

    xyz, valid = _scenes(dev, 2, 512)
    want = ops.farthest_point_sample(32, xyz, valid, impl="plain")
    before = ops.launch_counts()["fps"]
    with debug.plain_kernels():
        assert torch.equal(ops.farthest_point_sample(32, xyz, valid), want)
        assert ops.launch_counts()["fps"] == before
        assert torch.equal(ops.farthest_point_sample(32, xyz, valid, impl="cuda"), want)
    assert ops.launch_counts()["fps"] == before + 1
