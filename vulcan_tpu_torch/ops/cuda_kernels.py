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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    path.  Each ``.cu`` file compiles to an object in its own ``nvcc``
    process, all started together, and one more ``nvcc`` links them.  The
    library is written to a temporary name and renamed into place, so a
    concurrent or interrupted build never leaves a torn file."""
    global build_log
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(" ".join(cmd))
        build_log = "".join(logs)
        if failed:
            cmds = "\n".join(failed)
            raise RuntimeError(f"nvcc failed:\n{cmds}\n{build_log}")
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{build_log}"
            )
        os.replace(lib, out)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process.  Once
    it is loaded, a call reads one global and takes no lock."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            for name, args in (
                ("vulcan_bilateral", [p, p, i, i, i, p, f, p]),
                ("vulcan_fill_smooth", [p, p, i, i, i, i, f, f, p]),
                ("vulcan_fill_smooth_fused", [p, p, i, i, i, f, f, p]),
                ("vulcan_chained_gather", [p, p, p, i, i, i, i, i, i, p]),
                ("vulcan_subsample2", [p, p, i, i, p]),
            ):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = i
            _lib = lib
    return _lib


def _check(x: torch.Tensor, what: str, dtypes=(torch.float32,), ndim: int = 2) -> None:
    """Raise on what a kernel does not take: dtype, rank, layout, then a
    tensor that is not on the card (the wrappers send CPU tensors to the
    plain versions, never here)."""
    if x.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{what}: expected {names}, got {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _launch(fn, x: torch.Tensor, *args) -> int:
    """Call the C entry point ``fn(*args, stream)`` on ``x``'s device and
    PyTorch's current stream there; return its error code.  The stream
    travels as its raw handle (an int, no ``Stream`` object), and the
    current device is switched only when ``x`` lies on another one.
    (``torch._C`` is the binding ``torch.cuda`` itself calls.)"""
    dev = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if dev == torch._C._cuda_getDevice():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


def bilateral(depth: torch.Tensor, space_w: list[float], radius: int,
              inv_2sd: float) -> torch.Tensor:
    """Launch K1 (``csrc/bilateral.cu``) on an (H, W) float32 CUDA image."""
    _check(depth, "bilateral")
    if len(space_w) != (2 * radius + 1) ** 2:
        raise ValueError("bilateral: need (2r+1)^2 spatial weights")
    lib = load()
    out = torch.empty_like(depth)
    w_host = (ctypes.c_float * len(space_w))(*space_w)
    err = _launch(
        lib.vulcan_bilateral, depth, depth.data_ptr(), out.data_ptr(),
        depth.shape[0], depth.shape[1], radius,
        ctypes.cast(w_host, ctypes.c_void_p), inv_2sd,
    )
    _raise_on(err, "bilateral")
    return out


# K2's fill-round count is a template parameter: one launch takes up to
# FILL_SMOOTH_MAX_ROUNDS rounds and the smoothing pass (csrc/fill_smooth.cu
# kMaxRounds; the kernel refuses anything else).
FILL_SMOOTH_MAX_ROUNDS = 4


def fill_smooth_plan(rounds: int) -> tuple[tuple[int, bool], ...]:
    """K2's launches for ``rounds`` fill rounds and the smoothing pass, as
    ``(rounds_in_launch, smooth)`` pairs: fill-only launches of
    ``FILL_SMOOTH_MAX_ROUNDS`` rounds, then one launch that takes the rest
    and smooths.  ``rounds <= FILL_SMOOTH_MAX_ROUNDS`` is one launch."""
    if rounds < 0:
        raise ValueError(f"fill_smooth: rounds must be >= 0, got {rounds}")
    full, rest = divmod(rounds, FILL_SMOOTH_MAX_ROUNDS)
    if rest == 0 and full > 0:
        full, rest = full - 1, FILL_SMOOTH_MAX_ROUNDS
    return ((FILL_SMOOTH_MAX_ROUNDS, False),) * full + ((rest, True),)


def fill_smooth(d: torch.Tensor, plan: tuple[tuple[int, bool], ...],
                two_mu: float, half_mu: float) -> torch.Tensor:
    """Launch K2 (``csrc/fill_smooth.cu``) once per entry of ``plan``
    (``fill_smooth_plan``) on an (H, W) float32 CUDA z-buffer (+inf =
    empty); each launch reads the previous one's output."""
    _check(d, "fill_smooth")
    lib = load()
    h, w = d.shape
    src = d
    for rounds, smooth in plan:
        out = d.new_empty((h, w))
        err = _launch(lib.vulcan_fill_smooth, d, src.data_ptr(), out.data_ptr(),
                      h, w, rounds, int(smooth), two_mu, half_mu)
        _raise_on(err, "fill_smooth")
        src = out
    return src


# The fused kernel's round count is a template parameter (0..4); the
# renderer's default is 2.
FUSED_MAX_ROUNDS = 4


def fill_smooth_fused(d: torch.Tensor, rounds: int, two_mu: float,
                      half_mu: float) -> torch.Tensor:
    """Launch T1 (``csrc/fill_smooth_fused.cu``): K2's fill rounds and
    smoothing pass in ONE launch, on an (H, W) float32 CUDA z-buffer."""
    _check(d, "fill_smooth_fused")
    if not 0 <= rounds <= FUSED_MAX_ROUNDS:
        raise ValueError(f"fill_smooth_fused: rounds must be in [0, {FUSED_MAX_ROUNDS}]")
    lib = load()
    out = d.new_empty(d.shape)
    err = _launch(lib.vulcan_fill_smooth_fused, d, d.data_ptr(), out.data_ptr(),
                  d.shape[0], d.shape[1], rounds, two_mu, half_mu)
    _raise_on(err, "fill_smooth_fused")
    return out


# Chained gather (T2-T4): a table of at most GATHER_SMEM_ROWS rows is staged
# in shared memory, GATHER_COLS columns a block (2048 x 16 x 4 B = 128 KB); a
# taller table is read through L2 (csrc/gather.cu says why).
GATHER_SMEM_ROWS = 2048
GATHER_COLS = 16


def gather_path(rows: int) -> str:
    """"smem" or "l2": where the chained gather reads a table of ``rows``."""
    return "smem" if rows <= GATHER_SMEM_ROWS else "l2"


def chained_gather(table: torch.Tensor, idx: torch.Tensor, rounds: int) -> torch.Tensor:
    """Launch T2-T4 (``csrc/gather.cu``): ``rounds`` chained lookups
    ``v = table[idx[i, j], j]``, ``idx = |idx + int(v) + k| % T``, summing
    ``v``.  ``table`` (T, L) float32 or int32, T a power of two, L a
    multiple of 16, 16-byte aligned; ``idx`` (N, L) int32 with entries in
    [0, T)."""
    if table.ndim == 2:
        t_rows, cols = table.shape
        if t_rows < 1 or t_rows & (t_rows - 1) or cols % GATHER_COLS:
            raise ValueError(
                "chained_gather: the table's height must be a power of two and "
                f"its width a multiple of {GATHER_COLS}, got {tuple(table.shape)}"
            )
    _check(table, "chained_gather table", (torch.float32, torch.int32))
    _check(idx, "chained_gather idx", (torch.int32,))
    if table.data_ptr() % 16:
        raise ValueError("chained_gather: the table must be 16-byte aligned")
    if idx.shape[1] != table.shape[1]:
        raise ValueError("chained_gather: table and idx need the same number of columns")
    if table.device != idx.device:
        raise ValueError("chained_gather: table and idx on different devices")
    if rounds < 0:
        raise ValueError("chained_gather: rounds must be >= 0")
    lib = load()
    t_rows, cols = table.shape
    out = table.new_empty(idx.shape)
    use_smem = int(gather_path(t_rows) == "smem")
    err = _launch(
        lib.vulcan_chained_gather, table, table.data_ptr(), idx.data_ptr(),
        out.data_ptr(), idx.shape[0], t_rows, cols, rounds,
        int(table.dtype == torch.int32), use_smem,
    )
    _raise_on(err, "chained_gather")
    return out


def subsample2(x: torch.Tensor) -> torch.Tensor:
    """Launch T5 (``csrc/subsample.cu``): ``x[::2, ::2]`` of an (H, W)
    int32 or float32 CUDA image, as a new contiguous tensor."""
    _check(x, "subsample2", (torch.int32, torch.float32))
    lib = load()
    h, w = x.shape
    out = x.new_empty(((h + 1) // 2, (w + 1) // 2))
    err = _launch(lib.vulcan_subsample2, x, x.data_ptr(), out.data_ptr(), h, w)
    _raise_on(err, "subsample2")
    return out
