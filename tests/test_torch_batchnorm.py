"""The training-mode BatchNorm op (``ops/batchnorm.py``) on the CPU: its
plain forward and its backward, written out as the steps autograd takes,
against ``MaskedBatchNorm``'s own code and autograd through it (and the
ReLU after it), bit for bit in float32 and float64; the running
statistics' blend and ``running_statistics_held``. The kernels are held to
these plain versions on the card (``tests/test_torch_kernels.py``)."""

import pytest
import torch

from gspn_tpu_torch import ops
from gspn_tpu_torch.nn.layers import MaskedBatchNorm, PointMLP, running_statistics_held

F64 = torch.float64
EPS, MOMENTUM = 1e-3, 0.9
ROWS, C = 37, 6
POOL = [k / 10 for k in range(1, 60)]


def _variance(c, k):
    """The float64 ``E[x^2] - E[x]^2`` of channel ``k`` of an ``(ROWS, C)``
    input holding ``c`` (the sums in the order the plain version takes)."""
    x = torch.zeros((ROWS, C), dtype=F64)
    x[:, k] = c
    mean = x.sum(0)[k] / ROWS
    return float((x * x).sum(0)[k] / ROWS - mean * mean)


def _constants():
    """Constants for channels 0-3: two whose variance rounds below 0 (the
    clamp holds, its gradient is 0), 0.0 (exactly 0: the gradient passes)
    and one whose variance rounds above 0."""
    return [next(c for c in POOL if _variance(c, 0) < 0),
            next(c for c in POOL if _variance(c, 1) < 0), 0.0,
            next(c for c in POOL if _variance(c, 3) > 0)]


def _inputs(seed, mask_kind, constant_channels=False, dtype=F64):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((ROWS, C), generator=gen, dtype=F64) * 2.0 + 0.5
    if constant_channels:
        for k, v in enumerate(_constants()):
            x[:, k] = v
    mask = None
    if mask_kind == "masked":
        mask = torch.rand((ROWS,), generator=gen) > 0.3
    elif mask_kind == "all_masked":
        mask = torch.zeros((ROWS,), dtype=torch.bool)
    scale = 1.0 + 0.5 * torch.randn((C,), generator=gen, dtype=F64)
    bias = 0.3 * torch.randn((C,), generator=gen, dtype=F64)
    running = (0.2 * torch.randn((C,), generator=gen, dtype=F64),
               1.0 + torch.rand((C,), generator=gen, dtype=F64))
    g = torch.randn((ROWS, C), generator=gen, dtype=F64)
    return (x.to(dtype), mask, scale.to(dtype), bias.to(dtype),
            tuple(t.to(dtype) for t in running), g.to(dtype))


def _today(x, mask, scale, bias, running, relu, held=False):
    """``MaskedBatchNorm``'s own training code (and the ReLU after it) in
    ``x``'s dtype under autograd: ``(x, the module, output)``."""
    bn = MaskedBatchNorm(C, epsilon=EPS, momentum=MOMENTUM, dtype=x.dtype).to(x.dtype).train()
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
        bn.mean.copy_(running[0])
        bn.var.copy_(running[1])
    x = x.clone().requires_grad_(True)
    if held:
        with running_statistics_held():
            y = bn._normalize(x, mask)  # forward() would cast x to float32 first
    else:
        y = bn._normalize(x, mask)
    return x, bn, torch.relu(y) if relu else y


def _op(x, mask, scale, bias, running, relu, held=False):
    """The op's plain version: ``batch_norm_stats`` and ``batch_norm_apply``
    forward, ``batch_norm_grad_terms``, the sums and
    ``batch_norm_grad_input`` backward."""
    x = x.clone().requires_grad_(True)
    scale = scale.clone().requires_grad_(True)
    bias = bias.clone().requires_grad_(True)
    rm, rv = running[0].clone(), running[1].clone()
    y = ops.batch_norm_train(x, mask, scale, bias, rm, rv, eps=EPS, momentum=MOMENTUM,
                             update=not held, relu=relu, dtype=x.dtype, impl="plain")
    return x, scale, bias, rm, rv, y


def _same(a, b, what):
    assert a.dtype == b.dtype and torch.equal(a, b), (what, (a - b).abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
@pytest.mark.parametrize("mask_kind", ["unmasked", "masked", "all_masked"])
@pytest.mark.parametrize("constant_channels", [False, True], ids=["spread", "constant"])
def test_plain_op_matches_masked_batch_norm_autograd(mask_kind, relu, constant_channels, dtype):
    """Output, running statistics and the gradients of ``x``, ``scale`` and
    ``bias``: the op's plain forward and backward bit for bit the module's
    code and autograd through it. The constant channels include variances
    that round below 0 (the clamp holds) and to 0 (it passes the
    gradient); an all-masked batch clamps ``tot`` to 1."""
    x, mask, scale, bias, running, g = _inputs(1, mask_kind, constant_channels, dtype)
    xr, bn, yr = _today(x, mask, scale, bias, running, relu)
    yr.backward(g)
    xo, so, bo, rm, rv, yo = _op(x, mask, scale, bias, running, relu)
    yo.backward(g)
    _same(yo, yr, "output")
    _same(rm, bn.mean, "running mean")
    _same(rv, bn.var, "running var")
    _same(xo.grad, xr.grad, "dx")
    _same(so.grad, bn.scale.grad, "dscale")
    _same(bo.grad, bn.bias.grad, "dbias")
    if constant_channels and mask_kind == "unmasked" and dtype == F64:
        gate = ops.batch_norm_stats(x, mask, *[t.clone() for t in running], eps=EPS,
                                    momentum=MOMENTUM, impl="plain")[2 * C:3 * C]
        assert gate[:4].tolist() == [0.0, 0.0, 1.0, 1.0]  # two clamps hold, two pass


def test_running_statistics_held_leaves_the_buffers():
    """Within ``running_statistics_held`` the op normalizes by the batch
    statistics as always and leaves the running statistics as they were,
    as the module does."""
    x, mask, scale, bias, running, g = _inputs(2, "masked")
    _, bn, yr = _today(x, mask, scale, bias, running, True, held=True)
    _, _, _, rm, rv, yo = _op(x, mask, scale, bias, running, True, held=True)
    _same(yo, yr, "output")
    assert torch.equal(rm, running[0]) and torch.equal(rv, running[1])
    assert torch.equal(bn.mean, running[0]) and torch.equal(bn.var, running[1])


def test_running_statistics_blend():
    """The running statistics move as ``momentum * old + (1 - momentum) *
    batch``, the batch variance biased and over the weighted rows only."""
    x, mask, scale, bias, running, _ = _inputs(3, "masked")
    rm, rv = running[0].clone(), running[1].clone()
    ops.batch_norm_stats(x, mask, rm, rv, eps=EPS, momentum=0.7, impl="plain")
    kept = x[mask]
    torch.testing.assert_close(rm, 0.7 * running[0] + 0.3 * kept.mean(0), rtol=1e-12, atol=0)
    torch.testing.assert_close(rv, 0.7 * running[1] + 0.3 * kept.var(0, unbiased=False),
                               rtol=1e-11, atol=0)


@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
def test_grad_pieces_compose_the_backward(relu):
    """``batch_norm_grad_terms``, the column sums and
    ``batch_norm_grad_input`` give ``batch_norm_train``'s backward; a
    masked-out row takes only the direct term ``g * scale * rstd``."""
    x, mask, scale, bias, running, g = _inputs(4, "masked")
    stats = ops.batch_norm_stats(x, mask, *[t.clone() for t in running], eps=EPS,
                                 momentum=MOMENTUM, impl="plain")
    gy, ts, tr, td = ops.batch_norm_grad_terms(x, g, stats, scale, bias, relu=relu,
                                               impl="plain")
    dx = ops.batch_norm_grad_input(x, td, mask, stats, tr.sum(0), td.sum(0), impl="plain")
    xo, so, bo, _, _, yo = _op(x, mask, scale, bias, running, relu)
    yo.backward(g)
    _same(dx, xo.grad, "dx")
    _same(ts.sum(0), so.grad, "dscale")
    _same(gy.sum(0), bo.grad, "dbias")
    y = ops.batch_norm_apply(x, stats, scale, bias, relu=relu, dtype=F64, impl="plain")
    assert torch.equal(gy, torch.where(y <= 0, 0.0, g) if relu else g)
    _same(dx[~mask], td[~mask], "masked-out rows")


def test_bf16_output_casts_before_the_relu():
    """A bfloat16 layer's output is the float32 normalization cast, then the
    ReLU, as the module's caller applies it; its gradient returns in
    float32 to ``x``."""
    x, mask, scale, bias, running, _ = _inputs(5, "unmasked")
    x, scale, bias = x.float(), scale.float(), bias.float()
    running = tuple(t.float() for t in running)
    bn = MaskedBatchNorm(C, epsilon=EPS, dtype=torch.bfloat16).train()
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
    want = torch.relu(bn(x))
    got = ops.batch_norm_train(x.requires_grad_(True), None, scale, bias,
                               *[t.clone() for t in running], eps=EPS, momentum=MOMENTUM,
                               relu=True, dtype=torch.bfloat16, impl="plain")
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    got.float().sum().backward()
    assert x.grad.dtype == torch.float32


def test_point_mlp_applies_the_relu_through_its_batch_norm():
    """``PointMLP``'s layers pass their ReLU to the BatchNorm, which applies
    it after the normalization: the same output as a ReLU after it, and no
    ReLU after the last layer without ``last_activation``."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((3, 11, 5), generator=gen)
    for last in (True, False):
        mlp = PointMLP(5, (8, 4), last_activation=last).train()
        got = mlp(x)
        h = x.reshape(-1, 5)
        with running_statistics_held():
            for i in range(2):
                h = getattr(mlp, f"bn_{i}")(getattr(mlp, f"dense_{i}")(h, sum_in_f32=True))
                if i == 0 or last:
                    h = torch.relu(h)
        assert torch.equal(got, h.reshape(3, 11, 4))
        assert bool((got < 0).any()) != last
