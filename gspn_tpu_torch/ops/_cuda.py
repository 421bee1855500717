"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

Each source is compiled with ``nvcc`` to an object, all of them at once in
parallel, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so the build takes
seconds. It happens at the first CUDA launch (or an explicit
:func:`build`), into ``gspn_tpu_torch/_build/``, keyed by a hash of the
sources and flags. Nothing here runs at import time: the CPU tests import
every module on machines without ``nvcc``.

``-fmad=false`` keeps ``nvcc`` from contracting ``a*b+c`` into an FMA, so
squared distances round exactly as in the plain PyTorch versions and the
JAX package (strict ``d2 < r2`` tests and argmin/argmax tie-breaks depend
on it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
SOURCES = (
    "fps.cu", "ball_group.cu", "box_group.cu", "ball_query.cu", "three_nn.cu",
    "interp_mm.cu", "mask_project.cu", "nms.cu", "chamfer.cu",
)
HEADERS = ("common.cuh", "group_scan.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false",
)
LINK_FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a")

_ptr = ctypes.c_void_p
_int = ctypes.c_int


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def _library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libgspn_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[pathlib.Path, float]:
    """Compile the kernels if this source hash has no library yet: one
    ``nvcc -c`` per source, all started together, then one link. Returns
    ``(library path, seconds spent compiling)``; raises with the compiler's
    output when ``nvcc`` fails."""
    lib = _library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{pathlib.Path(s).stem}.o") for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(SOURCES, objs, strict=True)
        ]
        failed = []
        for src, proc in zip(SOURCES, procs, strict=True):
            out, err = proc.communicate()  # waits for every compiler
            if proc.returncode != 0:
                failed.append(f"{src} ({proc.returncode}):\n{out}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        so = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *LINK_FLAGS, "-o", so, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
            )
        os.replace(so, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    lib.gspn_error_string.argtypes = [_int]
    lib.gspn_error_string.restype = ctypes.c_char_p
    for k in KERNELS.values():
        fn = getattr(lib, k.symbol)
        fn.argtypes = list(k.argtypes) + [_ptr]  # trailing cudaStream_t
        fn.restype = _int
    return lib


class CudaKernel:
    """One kernel of ``csrc/``: its C entry point, where it came from, and
    ``launches``, the number of times a wrapper launched it."""

    def __init__(self, name, source, symbol, argtypes, replaces):
        self.name = name
        self.source = f"gspn_tpu_torch/csrc/{source}"
        self.symbol = symbol
        self.argtypes = tuple(argtypes)
        self.replaces = replaces
        self.launches = 0

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry point on ``device``'s current stream. Pointers
        are passed as ``int(tensor.data_ptr())`` (or 0 for null). Raises
        with CUDA's message when the launch is refused."""
        lib = library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, self.symbol)(*args, stream)
        if err != 0:
            msg = lib.gspn_error_string(err).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: {msg} ({err})")
        self.launches += 1


KERNELS: dict[str, CudaKernel] = {
    k.name: k
    for k in (
        CudaKernel(
            "fps", "fps.cu", "gspn_fps",
            # xyz, valid, rows, n, npoint, out
            (_ptr, _ptr, _int, _int, _int, _ptr),
            "gspn_tpu/ops/fps.py:80 _fps_kernel",
        ),
        CudaKernel(
            "ball_group", "ball_group.cu", "gspn_ball_group",
            # xyz1, valid1, xyz2, b, n, m, nscales, r2s, ks, idx[], cnt[], local[]
            (_ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr, _ptr, _ptr, _ptr, _ptr),
            "gspn_tpu/ops/ball_group.py:83 _fused_kernel",
        ),
        CudaKernel(
            "ball_group_strided", "ball_group.cu", "gspn_ball_group_strided",
            # as ball_group
            (_ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr, _ptr, _ptr, _ptr, _ptr),
            "gspn_tpu/ops/ball_group.py:318 _fused_kernel_strided",
        ),
        CudaKernel(
            "box_group", "box_group.cu", "gspn_box_group",
            # xyz1, valid1, boxes, b, n, r, s, idx, cnt, local
            (_ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr, _ptr, _ptr),
            "gspn_tpu/ops/box_group.py:38 _box_kernel",
        ),
        CudaKernel(
            "box_group_strided", "box_group.cu", "gspn_box_group_strided",
            # as box_group
            (_ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr, _ptr, _ptr),
            "gspn_tpu/ops/ball_group.py:318 _fused_kernel_strided (pred=\"box\")",
        ),
        CudaKernel(
            "ball_query", "ball_query.cu", "gspn_ball_query",
            # xyz1, valid1, xyz2, b, n, m, nscales, r2s, ks, idx[], cnt[]
            (_ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr, _ptr, _ptr, _ptr),
            "gspn_tpu/ops/ball_query.py:117 _ball_query_multi_kernel",
        ),
        CudaKernel(
            "ball_query_strided", "ball_query.cu", "gspn_ball_query_strided",
            # as ball_query
            (_ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr, _ptr, _ptr, _ptr),
            "gspn_tpu/ops/ball_query.py:117 _ball_query_multi_kernel (select=\"strided\")",
        ),
        CudaKernel(
            "three_nn", "three_nn.cu", "gspn_three_nn",
            # xyz1, xyz2, valid2, b, n, m, dist, idx
            (_ptr, _ptr, _ptr, _int, _int, _int, _ptr, _ptr),
            "gspn_tpu/ops/interpolate.py:38 _three_nn_kernel (M <= 2048); "
            "gspn_tpu/ops/interpolate.py:132 _three_nn_tiled_kernel (M > 2048)",
        ),
        CudaKernel(
            "interp_mm", "interp_mm.cu", "gspn_interp_mm",
            # points, idx, weight, b, n, m, c, out
            (_ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr),
            "gspn_tpu/ops/interpolate.py:347 _interp_mm_kernel",
        ),
        CudaKernel(
            "mask_project", "mask_project.cu", "gspn_mask_project",
            # xyz, sampled, logits, sample_valid, b, n, r, s, out
            (_ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr),
            "gspn_tpu/ops/mask_project.py:67 _mask_project_kernel",
        ),
        CudaKernel(
            "mask_project_boxed", "mask_project.cu", "gspn_mask_project_boxed",
            # xyz, sampled, logits, sample_valid, b, n, r, s,
            # relevance, roi_block, tile_n, relevance rows, relevance cols, out
            (_ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr, _int, _int, _int, _int, _ptr),
            "gspn_tpu/ops/mask_project.py:72 _mask_project_boxed_kernel",
        ),
        CudaKernel(
            "nms", "nms.cu", "gspn_nms",
            # iou, alive, b, r, thresh (f32), keep
            (_ptr, _ptr, _int, _int, ctypes.c_float, _ptr),
            "gspn_tpu/ops/nms.py:83 _nms_kernel",
        ),
        CudaKernel(
            "nn_argmin", "chamfer.cu", "gspn_nn_argmin",
            # xyz1, xyz2, valid2, b, n, m, idx
            (_ptr, _ptr, _ptr, _int, _int, _int, _ptr),
            "gspn_tpu/ops/chamfer.py:44 _nn_kernel",
        ),
    )
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else int(t.data_ptr())


def check_cuda_input(name: str, t: torch.Tensor, dtype, shape) -> None:
    """Validate a kernel argument in Python before its pointer goes to C."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
