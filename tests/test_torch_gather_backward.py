"""The gather backward ``index_add_rows`` on the CPU: its plain version
against ``scatter_add_`` and the JAX package's ``jax.grad`` of its gather,
at small analogues of the shapes the card runs it at, and the CUDA
kernel's tiling plan ``index_add_plan`` at those shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gspn_tpu import ops as jops
from gspn_tpu_torch import ops
from gspn_tpu_torch.ops import grouping as tgroup
from tests.torch_parity import n, t

# name -> (B, M positions, n rows, C, index layout): small analogues of the
# kernel's cases (utils/time_kernels.py cases)
CASES = {
    "chamfer": (6, 16, 16, 3, "random"),  # (G): GT -> pred positions, C 3
    "fp4": (2, 48, 16, 8, "three"),  # stage 2 FP4: three sources a target
    "roialign": (2, 40, 300, 4, "random"),  # many more rows than positions
    "crowd": (3, 64, 2, 5, "random"),  # 32 positions on each index
    "ragged": (2, 33, 10, 5, "random"),  # M not a multiple of 32
    "one_index": (2, 40, 7, 3, "one"),  # every position on one index
    "no_positions": (2, 0, 4, 3, "random"),  # M = 0: zeros
}


def _indices(rng, b, m, rows, layout):
    if layout == "three":  # three distinct rows a target, as three_nn gives
        return np.stack([np.stack([rng.choice(rows, 3, replace=False) for _ in range(m // 3)])
                         for _ in range(b)]).reshape(b, m).astype(np.int32)
    if layout == "one":
        return np.full((b, m), rows // 2, np.int32)
    return rng.integers(0, rows, (b, m)).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_index_add_rows_matches_scatter_add_and_jax(rng, case):
    """Bitwise ``scatter_add_`` (ascending positions from +0.0), the
    gradient of ``gather_point`` and ``jax.grad`` of the JAX package's
    ``gather_point``."""
    b, m, rows, c, layout = CASES[case]
    src = rng.standard_normal((b, m, c)).astype(np.float32)
    idx = _indices(rng, b, m, rows, layout)
    got = ops.index_add_rows(t(src), t(idx), rows)
    assert got.shape == (b, rows, c) and got.dtype == torch.float32
    want = torch.zeros((b, rows, c)).scatter_add_(
        1, t(idx).long()[..., None].expand(b, m, c), t(src))
    np.testing.assert_array_equal(n(got), n(want))

    pts = rng.standard_normal((b, rows, c)).astype(np.float32)
    p = t(pts).requires_grad_(True)
    (ops.gather_point(p, t(idx)) * t(src)).sum().backward()
    np.testing.assert_array_equal(n(p.grad), n(got))
    jg = jax.grad(lambda q: jnp.sum(jops.gather_point(q, jnp.asarray(idx)) * jnp.asarray(src)))(
        jnp.asarray(pts))
    np.testing.assert_array_equal(n(got), np.asarray(jg))


@pytest.mark.parametrize("b,m,rows,c,plan", [
    (256, 256, 256, 3, (256, 3)),  # (G) chamfer: one row tile a batch row
    (8, 24576, 1024, 128, (32, 128)),  # FP4's backward at the flagship's shape: 256 CTAs
    (1, 196608, 1024, 128, (8, 128)),  # the whole scene's FP4: 128 CTAs, index bytes = source's
    (8, 4096, 8192, 128, (64, 128)),  # RoIAlign backward, flagship
    (4, 5120, 4096, 128, (64, 128)),  # (I)'s RoIAlign backward: 80 RoIs x 64 samples
    (4, 12288, 1024, 128, (16, 128)),  # (I)'s FP4 backward: 256 CTAs
    (1, 4096, 65536, 128, (64, 128)),  # RoIAlign backward, whole scene
    (16, 4096, 8, 64, (1, 64)),  # 512 positions on each index
    (1, 65536, 1024, 3, (256, 3)),  # C 3: one row tile of 256 rows
    (3, 7, 50, 5, (12, 5)),
    (2, 100, 5000, 20000, (1, 8192)),  # C beyond one tile of sums
])
def test_index_add_plan(b, m, rows, c, plan):
    """The kernel's tiling at each case's shape (M sets none of it), within
    the kernel's limits: the sums of a CTA fit, the row tiles narrowed
    toward INDEX_ADD_TARGET_CTAS CTAs while a batch row's CTAs, each
    reading its M indices, stay within C."""
    got = tgroup.index_add_plan(b, rows, c)
    assert got == plan
    bins, tile_c = got
    assert 1 <= bins <= tgroup.INDEX_ADD_MAX_BINS and bins * tile_c <= tgroup.INDEX_ADD_ACC_FLOATS
    assert tile_c == min(c, tgroup.INDEX_ADD_ACC_FLOATS)

    def ctas(bins):  # a batch row's
        return -(-rows // bins) * -(-c // tile_c)

    # no narrower row tiles once the launch has enough CTAs, or past C a
    # batch row
    assert (bins == 1 or b * ctas(bins) >= tgroup.INDEX_ADD_TARGET_CTAS
            or ctas(bins // 2) > c)
