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


def test_fps_kernel_refuses_rows_beyond_shared_memory(dev):
    xyz = torch.zeros((1, tfps.FPS_MAX_N + 1, 3), device=dev)
    with pytest.raises(ValueError, match="shared"):
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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,radii,ks,m", _BALL_CASES)
def test_ball_group_strided_kernel(dev, b, n, radii, ks, m, masked):
    """Bitwise its plain version; where a ball overflows K, not first-K."""
    xyz, valid = _scenes(dev, b, n)
    q = _centres(dev, xyz, m)
    v = valid if masked else None
    before = tball.STRIDED_KERNEL.launches
    got = ops.query_ball_group_multi(radii, ks, xyz, q, v, impl="cuda", select="strided")
    torch.cuda.synchronize()
    assert tball.STRIDED_KERNEL.launches == before + 1
    want = ops.query_ball_group_multi(radii, ks, xyz, q, v, impl="plain", select="strided")
    first = ops.query_ball_group_multi(radii, ks, xyz, q, v, impl="cuda")
    for g, w in zip(got, want, strict=True):
        for x, y in zip(g, w, strict=True):
            _equal(x, y)
    if n > 1000:
        assert any(not torch.equal(g[0], f[0]) for g, f in zip(got, first, strict=True))


@pytest.mark.parametrize("select", ["first", "strided"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,radii,ks,m", _BALL_CASES)
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


def _rois(dev, xyz, r, seed=2):
    b, n, _ = xyz.shape
    gen = torch.Generator().manual_seed(seed)
    c = xyz[:, torch.randperm(n, generator=gen)[:r].to(dev)]
    half = torch.rand((b, r, 3), generator=gen).to(dev) * 0.5
    half[:, :2] = 1e-4  # near-empty boxes exercise padding and empty rows
    return torch.cat([c - half, c + half], dim=-1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,r,s", [(8, 8192, 64, 64), (2, 100, 5, 8)])
def test_box_group_kernel(dev, b, n, r, s, masked):
    xyz, valid = _scenes(dev, b, n)
    boxes = _rois(dev, xyz, r)
    v = valid if masked else None
    got = ops.query_box_group(boxes, s, xyz, v, impl="cuda")
    want = ops.query_box_group(boxes, s, xyz, v, impl="plain")
    torch.cuda.synchronize()
    for x, y in zip(got, want, strict=True):
        _equal(x, y)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,r,s", [(8, 8192, 64, 64), (1, 65536, 64, 64), (2, 100, 5, 8)])
def test_box_group_strided_kernel(dev, b, n, r, s, masked):
    xyz, valid = _scenes(dev, b, n)
    boxes = _rois(dev, xyz, r)
    v = valid if masked else None
    before = tbox.STRIDED_KERNEL.launches
    got = ops.query_box_group(boxes, s, xyz, v, impl="cuda", select="strided")
    torch.cuda.synchronize()
    assert tbox.STRIDED_KERNEL.launches == before + 1
    want = ops.query_box_group(boxes, s, xyz, v, impl="plain", select="strided")
    for x, y in zip(got, want, strict=True):
        _equal(x, y)
    if n > 1000:
        assert not torch.equal(got[0], ops.query_box_group(boxes, s, xyz, v, impl="cuda")[0])


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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,r", [(8, 64), (2, 1024), (3, 5)])
def test_nms_kernel(dev, b, r, masked):
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


def test_nms_kernel_refuses_more_than_1024_boxes(dev):
    boxes, scores, _ = _nms_case(dev, 1, 1025)
    with pytest.raises(ValueError, match="at most 1024"):
        ops.nms_3d_batched(boxes, scores, 0.25, impl="cuda")


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


@pytest.mark.parametrize(
    "b,n,m,c",
    [(8, 8192, 1024, 128), (8, 64, 16, 512), (1, 65536, 1024, 128), (2, 100, 5, 7),
     (1, 4096, 2100, 1000)],  # the last above the TPU kernel's 8 MB source block
)
def test_interp_mm_kernel(dev, b, n, m, c):
    gen = torch.Generator().manual_seed(4)
    pts = torch.randn((b, m, c), generator=gen).to(dev)
    idx = torch.randint(0, m, (b, n, 3), generator=gen, dtype=torch.int32)
    idx[:, ::7, 1] = idx[:, ::7, 0]  # repeated sources
    idx[:, ::11, 2] = idx[:, ::11, 0]
    idx[:, ::13, :] = idx[:, ::13, :1]
    w = torch.rand((b, n, 3), generator=gen).to(dev)
    idx = idx.to(dev)
    before = tinterp.MM_KERNEL.launches
    got = ops.three_interpolate_mm(pts, idx, w, impl="cuda")
    want = ops.three_interpolate_mm(pts, idx, w, impl="plain")
    torch.cuda.synchronize()
    assert tinterp.MM_KERNEL.launches == before + 1
    _equal(got, want)
    _equal(got, ops.three_interpolate(pts, idx, w))


def _projection(dev, b, n, r, s, seed=5):
    """Scenes, RoI samples about scene points on a 1 cm grid (equal
    distances), duplicated sample coordinates with other logits, boxes."""
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
    boxes = torch.cat([samp[:, :, 0] - half, samp[:, :, 0] + half], dim=-1)
    return xyz, valid, samp, logits, svalid, boxes


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,r,s", [(8, 8192, 64, 64), (1, 65536, 64, 64), (2, 300, 5, 70)])
def test_mask_project_kernel(dev, b, n, r, s, masked):
    xyz, _, samp, logits, svalid, _ = _projection(dev, b, n, r, s)
    v = svalid if masked else None
    before = tmask.KERNEL.launches
    got = ops.nearest_sample_logit(xyz, samp, logits, v, impl="cuda")
    want = ops.nearest_sample_logit(xyz, samp, logits, v, impl="plain")
    torch.cuda.synchronize()
    assert tmask.KERNEL.launches == before + 1
    _equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "b,n,r,s,tiling",
    [(8, 8192, 64, 64, {}), (1, 65536, 64, 64, {}), (2, 300, 13, 6, dict(roi_block=8, tile_n=128))],
)
def test_mask_project_boxed_kernel(dev, b, n, r, s, tiling, masked):
    """On the Morton-sorted scenes, as the pipeline calls it: bitwise the
    plain version everywhere, the fill included, and the dense logit at
    every valid point inside a box."""
    xyz, valid, samp, logits, svalid, boxes = _projection(dev, b, n, r, s)
    sxyz, svld, _ = ops.spatial_sorted_view(xyz, valid if masked else None)
    v = svalid if masked else None
    before = tmask.BOXED_KERNEL.launches
    got = ops.nearest_sample_logit_boxed(sxyz, samp, logits, boxes, v, svld, impl="cuda", **tiling)
    want = ops.nearest_sample_logit_boxed(sxyz, samp, logits, boxes, v, svld, impl="plain",
                                          **tiling)
    torch.cuda.synchronize()
    assert tmask.BOXED_KERNEL.launches == before + 1
    _equal(got, want)
    dense = ops.nearest_sample_logit(sxyz, samp, logits, v, impl="plain")
    inside = ops.box_contains(boxes, sxyz, svld)
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
@pytest.mark.parametrize("b,n,m", [(256, 256, 256), (16, 4096, 4096), (3, 100, 7), (2, 5, 3000)])
def test_nn_argmin_kernel(dev, b, n, m, masked):
    """Bitwise its plain version (the chamfer step's 256 x 256 <- 256, a
    tiled 4096 sources, ragged sizes); a fully padded row gets index 0."""
    tgt, src, valid = _nn_case(dev, b, n, m)
    v = valid if masked else None
    before = tchamfer.KERNEL.launches
    got = ops.nn_argmin(tgt, src, v, impl="cuda")
    torch.cuda.synchronize()
    assert tchamfer.KERNEL.launches == before + 1
    _equal(got, ops.nn_argmin(tgt, src, v, impl="plain"))
    if masked:
        assert not got[0].any()


def test_nn_distance_auto_launches_the_kernel(dev):
    tgt, src, valid = _nn_case(dev, 256, 256, 256)
    before = tchamfer.KERNEL.launches
    got = ops.nn_distance(tgt, src, valid2=valid)
    torch.cuda.synchronize()
    assert tchamfer.KERNEL.launches == before + 2
    want = ops.nn_distance(tgt, src, valid2=valid, impl="plain")
    assert tchamfer.KERNEL.launches == before + 2
    for x, y in zip(got, want, strict=True):
        _equal(x, y)


def test_train_step_kernel_path_matches_plain_path(dev):
    """One GSPN training step at full width on the slice's batch: the loss
    and its terms within rtol 1e-5 / atol 1e-6 (the kernels are bitwise,
    the rest is the same PyTorch), the gradients as
    ``bench_slice.assert_grads_close`` holds them (``gather``'s backward
    adds with atomics in no fixed order)."""
    bench_slice.float32_matmuls()
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
    assert launched == {"fps": 1, "ball_group": 1, "nn_argmin": 2} and not plain_launched
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)
    bench_slice.assert_grads_close(grads, pgrads)
