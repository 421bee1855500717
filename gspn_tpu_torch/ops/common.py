"""Shared helpers for the point-op library.

Every op with a hand-written CUDA kernel takes ``impl="auto|cuda|plain"``,
the PyTorch counterpart of the JAX package's ``auto|pallas|xla``:

- ``"auto"``: the kernel for a CUDA tensor, the plain PyTorch version for a
  CPU tensor. This is the only place a plain version is chosen for the
  caller; a CUDA tensor never falls back to it.
- ``"cuda"``: the kernel; a CPU tensor raises.
- ``"plain"``: the plain PyTorch version on any device. It is the reference
  a kernel is held against (tests, ``chip_smoke.py``), never the main path.

Each such op calls its kernel or its plain version through one op of the
``gspn`` namespace (:func:`gspn_op`), so ``torch.export`` keeps the call
as one opaque node; eager calls take the same op.
"""

from __future__ import annotations

import torch

LIBRARY = torch.library.Library("gspn", "DEF")


def gspn_op(name: str):
    """Decorator: defines ``gspn::name`` from the function's annotations
    (``torch.library.infer_schema``; no input is mutated) with the function
    as its implementation on every device, and returns the op. Register
    its fake version (the output shapes from the input shapes alone) with
    ``torch.library.register_fake(op)``.

    The op is defined on a ``torch.library.Library`` rather than through
    ``torch.library.custom_op``, whose Python wrapper and autograd kernel
    run on every eager call; an op with a gradient adds its own
    (``torch.library.register_autograd``)."""

    def define(fn):
        LIBRARY.define(name + torch.library.infer_schema(fn, mutates_args=()))
        LIBRARY.impl(name, fn, "CompositeExplicitAutograd")
        return getattr(torch.ops.gspn, name).default

    return define


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """Resolve ``impl`` for the tensor ``x`` to ``"cuda"`` or ``"plain"``."""
    if impl == "auto":
        return "cuda" if x.is_cuda else "plain"
    if impl == "cuda":
        if not x.is_cuda:
            raise ValueError(f"impl='cuda' needs a CUDA tensor, got {x.device}")
        return "cuda"
    if impl == "plain":
        return "plain"
    raise ValueError(f"impl must be auto|cuda|plain, got {impl!r}")


def sqdist_components(dx, dy, dz):
    """``dx*dx + dy*dy + dz*dz`` in exactly that order, so the rounding
    matches the JAX package, the NumPy oracles and the CUDA kernels (which
    compile with ``-fmad=false``); threshold tests and argmin/argmax
    tie-breaks depend on it."""
    return dx * dx + dy * dy + dz * dz


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances, ``a (..., N, 3), b (..., M, 3) -> (..., N, M)``,
    from explicit differences (not the ``|a|^2 - 2ab + |b|^2`` expansion)."""
    d = [a[..., :, None, i] - b[..., None, :, i] for i in range(3)]
    return sqdist_components(*d)


def masked_sqdist(a, b, b_valid, fill: float = 1e10):
    """``pairwise_sqdist`` with invalid columns (padded ``b`` points) set to
    ``fill``."""
    d2 = pairwise_sqdist(a, b)
    if b_valid is not None:
        d2 = torch.where(b_valid[..., None, :], d2, torch.full_like(d2, fill))
    return d2


def f32_scalar(x: float, device) -> torch.Tensor:
    """A Python float rounded once to float32, as JAX rounds a weak-typed
    Python scalar against an f32 array (e.g. ``d2 < r*r``)."""
    return torch.tensor(x, dtype=torch.float32, device=device)
