"""Build and bind the port's hand-written Hopper kernels (``csrc/*.cu``).

The CUDA sources are compiled at first use with ``nvcc`` for ``sm_90a``
into ONE shared library with a plain C interface, loaded with ``ctypes``.
Pointers and the CUDA stream travel as ``c_void_p``; every C entry point
returns ``cudaGetLastError()`` and the launch helpers below raise when it
is not 0.  The library goes to ``<repo>/build/vulcan_tpu_torch_kernels/
<hash>/``, keyed on a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.

Importing this module needs neither ``nvcc`` nor a GPU: nothing is built
or loaded until a kernel is launched on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "vulcan_tpu_torch_kernels"
# No --use_fast_math: expf and IEEE division keep the kernels within ulps
# of the plain versions.  -Xptxas -v reports registers/shared memory/spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output of the last build in this process


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [DEFAULT_NVCC]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "vulcan_tpu_torch are built from source at first use"
        )
    return found


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libvulcan_tpu_torch.so"


def build() -> Path:
    """Compile the sources if the hashed library is missing; return its
    path.  The library is written to a temporary name and renamed into
    place, so a concurrent or interrupted build never leaves a torn file."""
    global build_log
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{build_log}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.vulcan_bilateral.argtypes = [p, p, i, i, i, p, f, p]
            lib.vulcan_bilateral.restype = i
            lib.vulcan_fill_smooth.argtypes = [p, p, p, p, i, i, i, f, f, p]
            lib.vulcan_fill_smooth.restype = i
            _lib = lib
    return _lib


def _check_image(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: expected float32, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"{what}: expected an (H, W) image, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def bilateral(depth: torch.Tensor, space_w: list[float], radius: int,
              inv_2sd: float) -> torch.Tensor:
    """Launch K1 (``csrc/bilateral.cu``) on an (H, W) float32 CUDA image."""
    _check_image(depth, "bilateral")
    if len(space_w) != (2 * radius + 1) ** 2:
        raise ValueError("bilateral: need (2r+1)^2 spatial weights")
    lib = load()
    out = torch.empty_like(depth)
    w_host = (ctypes.c_float * len(space_w))(*space_w)
    with torch.cuda.device(depth.device):
        err = lib.vulcan_bilateral(
            depth.data_ptr(), out.data_ptr(), depth.shape[0], depth.shape[1],
            radius, ctypes.cast(w_host, ctypes.c_void_p), inv_2sd,
            _stream(depth),
        )
    _raise_on(err, "bilateral")
    return out


def fill_smooth(d: torch.Tensor, rounds: int, two_mu: float,
                half_mu: float) -> torch.Tensor:
    """Launch K2 (``csrc/fill_smooth.cu``) on an (H, W) float32 CUDA
    z-buffer (+inf = empty)."""
    _check_image(d, "fill_smooth")
    lib = load()
    a = torch.empty_like(d)
    b = torch.empty_like(d)
    out = torch.empty_like(d)
    with torch.cuda.device(d.device):
        err = lib.vulcan_fill_smooth(
            d.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
            d.shape[0], d.shape[1], rounds, two_mu, half_mu, _stream(d),
        )
    _raise_on(err, "fill_smooth")
    return out
