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
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "vulcan_tpu_torch_kernels"
# No --use_fast_math: IEEE division and exact adds keep the kernels within
# ulps of the plain versions (K1 asks for its one approximate instruction,
# ex2.approx, by name).  -Xptxas -v reports registers/shared memory/spills.
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


def library_path(sources: list[Path] | None = None,
                 defines: tuple[str, ...] = ()) -> Path:
    """Where the library for the current sources lives (built or not).  The
    default is every source and no ``-D``; a variant (one source with
    ``defines``, ``build_variant``) gets a directory of its own."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for src in _sources() if sources is None else sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libvulcan_tpu_torch.so"


def _compile(sources: list[Path], defines: tuple[str, ...], out: Path) -> str:
    """Compile ``sources`` into the shared library ``out``; return nvcc's
    output.  Each ``.cu`` file compiles to an object in its own ``nvcc``
    process, all started together, and one more ``nvcc`` links them.  The
    library is written to a temporary name and renamed into place, so a
    concurrent or interrupted build never leaves a torn file."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in sources:
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *flags, "-I", str(CSRC), "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(" ".join(cmd))
        log = "".join(logs)
        if failed:
            cmds = "\n".join(failed)
            raise RuntimeError(f"nvcc failed:\n{cmds}\n{log}")
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}"
            )
        os.replace(lib, out)
    return log


def build() -> Path:
    """Compile the sources if the hashed library is missing; return its
    path."""
    global build_log
    out = library_path()
    if not out.is_file():
        build_log = _compile([s for s in _sources() if s.suffix == ".cu"], (), out)
    return out


def build_variant(source: str, defines: tuple[str, ...]) -> tuple[ctypes.CDLL, str]:
    """Build ``csrc/<source>`` alone with ``-D<define>`` for each of
    ``defines`` and load it: a kernel's compile-time alternatives, for the
    probes that time them against the built-in choice.  Returns the library
    (its functions' ``argtypes`` are the caller's to set) and nvcc's output
    ("" when the library was already there)."""
    src = [CSRC / source]
    out = library_path(src, defines)
    log = "" if out.is_file() else _compile(src, defines, out)
    return ctypes.CDLL(str(out)), log


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "vulcan_bilateral": [_P, _P, _I, _I, _I, _P, _F, _P, _P],
    "vulcan_fill_smooth": [_P, _P, _I, _I, _I, _I, _F, _F, _P, _P],
    "vulcan_fill_smooth_fused": [_P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    "vulcan_chained_gather": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "vulcan_gather_max_clusters": [_I, _I, _I, _I, _I, _I, _I],
    "vulcan_subsample2": [_P, _P, _I, _I, _P],
    "vulcan_icp_associate": [_P] * 9 + [_I] * 3 + [_F] * 6 + [_I] * 2 + [_P] * 7,
    "vulcan_icp_rows": [_P] * 15 + [_I] + [_F] * 11 + [_I] * 3 + [_P] * 3,
    "vulcan_icp_solve": [_P, _P, _F, _I, _I, _I, _P, _P, _P],
    "vulcan_icp_rows_solve": [_P] * 15 + [_I] + [_F] * 12 + [_I] * 3 + [_P] * 4,
    "vulcan_graph_prepare": [_P],
    "vulcan_graph_stream": [_P],
    "vulcan_graph_while": [_P, _I, _P, _P, _P, _P, _P],
    "vulcan_graph_while_next": [ctypes.c_ulonglong, _P, _I, _I, _P, _P, _P],
    "vulcan_graph_cond": [_P, _I, _P, _P, _P],
    "vulcan_graph_body_begin": [_P, _P],
    "vulcan_graph_body_end": [_P],
    "vulcan_trace_prepare": [_P],
    "vulcan_trace_mark": [_P, _P, _I, _I, _I, _I, _P, _P],
    "vulcan_range_stamp": [_P] * 11 + [_I] * 4 + [_P] * 4,
    "vulcan_range_expand": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    "vulcan_integrate": [_P] * 5 + [_I] * 5 + [_F] * 14 + [_P] * 9,
    "vulcan_splat_zbuf": [_I] + [_P] * 8 + [_I] * 5 + [_F] * 9 + [_P] * 3,
}


def bind(lib: ctypes.CDLL, names=tuple(_SIGNATURES)) -> ctypes.CDLL:
    """Give the C entry points ``names`` of ``lib`` their argument types
    (without them ctypes passes a pointer as a 32-bit int and cuts it)."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = _I
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process.  Once
    it is loaded, a call reads one global and takes no lock."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build())))
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


# Launch counters on the card (csrc/launch_count.cuh): one word a counted
# kernel a device, to which each launch of the kernel adds one on the card,
# eagerly or in a replay of a CUDA graph (whose launches the host never
# sees).  ``launch_counts`` reads them, ``reset_launch_counts`` zeroes them.
COUNTED = ("bilateral", "fill_smooth", "icp_associate", "icp_rows", "icp_solve",
           "icp_rows_solve", "graph_while", "graph_while_next", "graph_ifelse", "trace_mark",
           "range_stamp", "range_expand", "integrate", "splat_zbuf")
_counters: dict[int, torch.Tensor] = {}


def launch_counter(x: torch.Tensor, name: str) -> int:
    """The address of kernel ``name``'s launch counter on ``x``'s device.
    The counters are made at the first eager launch (or ``graph_prepare``),
    never inside a capture."""
    dev = x.get_device()
    words = _counters.get(dev)
    if words is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the launch counters are made before a capture")
        words = _counters[dev] = torch.zeros(len(COUNTED), dtype=torch.int32,
                                             device=x.device)
    return words.data_ptr() + 4 * COUNTED.index(name)


def launch_counts(device=None) -> dict[str, int]:
    """Each counted kernel's launches on ``device`` (every device when
    None) since the counters were made or last reset: one device->host copy,
    which waits for the device."""
    if device is None:
        words = list(_counters.values())
    else:
        dev = torch.device(device)
        words = [_counters[dev.index or 0]] if (dev.index or 0) in _counters else []
    got = torch.stack(words).sum(0).tolist() if words else [0] * len(COUNTED)
    return dict(zip(COUNTED, got))


def launch_snapshot(device) -> torch.Tensor | None:
    """A copy of ``device``'s launch counters taken on the card, in stream
    order and without waiting for it (None before any counted launch):
    snapshots read together later give the launches between them."""
    words = _counters.get(torch.device(device).index or 0)
    return None if words is None else words.clone()


def reset_launch_counts() -> None:
    """Every device's launch counters to 0."""
    for words in _counters.values():
        words.zero_()


BILATERAL_MAX_RADIUS = 4        # csrc/bilateral.cu kMaxRadius
# K1 stages an invalid or off-image depth as this value: its squared distance
# to any real depth (1e36) times the range factor must drive ex2 to 0.
BILATERAL_INVALID = -1e18


class BilateralConstants(NamedTuple):
    """K1's per-``Config`` constants, ready for the launch.  The weight of a
    tap, ``exp(-(dy^2+dx^2)/(2 ss^2)) * exp(-diff^2/(2 sd^2))``, is folded
    into one power of two, ``exp2(diff^2 * neg_a + neg_s[dy, dx])``; both
    constants are computed in double and rounded to float32."""
    radius: int
    neg_a: float                    # -log2(e) / (2 sigma_depth^2)
    neg_s: tuple[float, ...]        # -(dy^2 + dx^2) log2(e) / (2 sigma_space^2), dy-outer
    array: ctypes.Array             # neg_s as the float array the C entry reads
    pointer: ctypes.c_void_p        # its address (``array`` keeps it alive)


def _f32(x: float) -> float:
    return ctypes.c_float(x).value


@functools.lru_cache(maxsize=16)
def bilateral_constants(radius: int, sigma_space: float,
                        sigma_depth: float) -> BilateralConstants:
    """The folded constants of K1 for one filter setting, built once: a
    later call with the same setting returns the same object, so a frame
    computes no exponential and builds no ctypes array."""
    if not 0 <= radius <= BILATERAL_MAX_RADIUS:
        raise ValueError(f"bilateral: radius must be in [0, {BILATERAL_MAX_RADIUS}], "
                         f"got {radius}")
    log2e = math.log2(math.e)
    neg_a = _f32(-log2e / (2.0 * sigma_depth**2))
    # ex2 of anything below -150 is 0 in float32: an invalid tap weighs nothing
    if not neg_a * BILATERAL_INVALID**2 < -200.0:
        raise ValueError(f"bilateral: sigma_depth {sigma_depth} is out of the kernel's range")
    inv_2ss = log2e / (2.0 * sigma_space**2)
    neg_s = tuple(
        _f32(-(dy * dy + dx * dx) * inv_2ss)
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)
    )
    array = (ctypes.c_float * len(neg_s))(*neg_s)
    return BilateralConstants(radius, neg_a, neg_s, array,
                              ctypes.cast(array, ctypes.c_void_p))


def bilateral(depth: torch.Tensor, constants: BilateralConstants) -> torch.Tensor:
    """Launch K1 (``csrc/bilateral.cu``) on an (H, W) float32 CUDA image
    with the constants of ``bilateral_constants``."""
    _check(depth, "bilateral")
    lib = load()
    out = depth.new_empty(depth.shape)
    err = _launch(
        lib.vulcan_bilateral, depth, depth.data_ptr(), out.data_ptr(),
        depth.shape[0], depth.shape[1], constants.radius, constants.pointer,
        constants.neg_a, launch_counter(depth, "bilateral"),
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
    src, counter = d, launch_counter(d, "fill_smooth")
    for rounds, smooth in plan:
        out = d.new_empty((h, w))
        err = _launch(lib.vulcan_fill_smooth, d, src.data_ptr(), out.data_ptr(),
                      h, w, rounds, int(smooth), two_mu, half_mu, counter)
        _raise_on(err, "fill_smooth")
        src = out
    return src


# The fused kernel's round count is a template parameter (0..4); the
# renderer's default is 2.  A warp owns a strip of FUSED_STRIP_ROWS output
# rows; its 32 lanes are 32 adjacent columns, ``rounds + 1`` of them halo on
# each side (``fused_core``, ``fused_strips``).
FUSED_MAX_ROUNDS = 4
FUSED_STRIP_ROWS = 12
FUSED_WARPS_PER_BLOCK = 4
FUSED_MAX_WARPS = 8                 # csrc/fill_smooth_fused.cu kMaxWarps


def fused_core(rounds: int) -> int:
    """The output columns of one warp of T1: its 32 lanes less the halo of
    ``rounds + 1`` on each side."""
    if not 0 <= rounds <= FUSED_MAX_ROUNDS:
        raise ValueError(f"fill_smooth_fused: rounds must be in [0, {FUSED_MAX_ROUNDS}]")
    return 32 - 2 * (rounds + 1)


def fused_strips(h: int, w: int, rounds: int,
                 strip_rows: int = FUSED_STRIP_ROWS) -> list[tuple[int, int, int, int]]:
    """T1's partition of an (h, w) image, a pure function: the output
    rectangles ``(row_begin, row_end, col_begin, col_end)`` of its warps, in
    the kernel's order (row-major over the strips).  A warp holds
    ``fused_core(rounds)`` output columns and ``rounds + 1`` columns of halo
    on each side, and reads the same halo of rows above and below its
    strip."""
    core = fused_core(rounds)
    if strip_rows < 1:
        raise ValueError(f"fill_smooth_fused: strip_rows must be >= 1, got {strip_rows}")
    return [(y, min(h, y + strip_rows), x, min(w, x + core))
            for y in range(0, h, strip_rows) for x in range(0, w, core)]


def fill_smooth_fused(d: torch.Tensor, rounds: int, two_mu: float, half_mu: float,
                      strip_rows: int = FUSED_STRIP_ROWS,
                      warps_per_block: int = FUSED_WARPS_PER_BLOCK) -> torch.Tensor:
    """Launch T1 (``csrc/fill_smooth_fused.cu``): K2's fill rounds and
    smoothing pass in ONE launch, on an (H, W) float32 CUDA z-buffer."""
    _check(d, "fill_smooth_fused")
    if not 0 <= rounds <= FUSED_MAX_ROUNDS:
        raise ValueError(f"fill_smooth_fused: rounds must be in [0, {FUSED_MAX_ROUNDS}]")
    if strip_rows < 1 or not 1 <= warps_per_block <= FUSED_MAX_WARPS:
        raise ValueError("fill_smooth_fused: strip_rows must be >= 1 and warps_per_block "
                         f"in [1, {FUSED_MAX_WARPS}], got {strip_rows}, {warps_per_block}")
    lib = load()
    out = d.new_empty(d.shape)
    err = _launch(lib.vulcan_fill_smooth_fused, d, d.data_ptr(), out.data_ptr(),
                  d.shape[0], d.shape[1], rounds, strip_rows, warps_per_block,
                  two_mu, half_mu)
    _raise_on(err, "fill_smooth_fused")
    return out


# Chained gather (T2-T4), three paths by the table's height (csrc/gather.cu
# says why): up to GATHER_SMEM_ROWS rows a block stages whole columns in its
# shared memory, GATHER_COLS (copy, column) pairs a row ("smem",
# ``smem_plan``); while one whole column still fits a block's
# GATHER_BLOCK_BYTES, a block holds one or two whole columns ("columns",
# ``gather_plan``); a taller table is read through L2 ("l2").
GATHER_SMEM_ROWS = 2048
GATHER_COLS = 16
GATHER_BLOCK_BYTES = 232448         # 227 KB: what one block may use on sm_90
GATHER_PATHS = ("smem", "columns", "l2")
GATHER_COLUMNS_THREADS = 512        # csrc/gather.cu kColumnsThreads
GATHER_COLUMNS_CHAINS = 8           # csrc/gather.cu kColumnsChains
GATHER_SMEM_COLS_PER_BLOCK = 16     # the smem path's own choice (PERF.md has the table)
GATHER_SMEM_MAX_CLUSTER = 8         # the portable cluster size


def gather_path(rows: int) -> str:
    """"smem", "columns" or "l2": where the chained gather keeps a table of
    ``rows`` rows, by its size alone."""
    if rows <= GATHER_SMEM_ROWS:
        return "smem"
    return "columns" if rows * 4 <= GATHER_BLOCK_BYTES else "l2"


class GatherPlan(NamedTuple):
    """How the columns path cuts an (N, L) gather from a (T, L) table into
    blocks.  A cluster of ``cluster_blocks`` blocks (1: a block alone, a
    plain launch) owns ``group_cols`` adjacent columns, ``cols_per_block`` of
    them whole in each block's shared memory; ``row_slabs`` clusters share a
    column group, each taking ``rows_per_slab`` rows of idx, which its blocks
    split evenly across all of the group's columns."""
    cols_per_block: int
    cluster_blocks: int
    row_slabs: int
    rows_per_slab: int
    interleaved: bool = False       # a block's columns as col[r * cpb + c], else planar

    @property
    def group_cols(self) -> int:
        return self.cols_per_block * self.cluster_blocks

    def smem_bytes(self, t_rows: int) -> int:
        return t_rows * self.cols_per_block * 4

    def grid(self, cols: int) -> tuple[int, int]:
        return (cols // self.group_cols * self.cluster_blocks, self.row_slabs)

    def block_extent(self, bx: int, by: int, n: int) -> tuple[int, int, int, int]:
        """(row_begin, row_end, col_begin, col_end) of idx and out that block
        (bx, by) of the grid takes, as the kernel computes it."""
        group, rank = divmod(bx, self.cluster_blocks)
        slab_end = min(n, (by + 1) * self.rows_per_slab)
        share = -(-self.rows_per_slab // self.cluster_blocks)
        r0 = min(slab_end, by * self.rows_per_slab + rank * share)
        return (r0, min(slab_end, r0 + share),
                group * self.group_cols, (group + 1) * self.group_cols)

    def staged_extent(self, bx: int, t_rows: int) -> tuple[int, int, int, int]:
        """(row_begin, row_end, col_begin, col_end) of the table that block
        ``bx`` holds in its shared memory."""
        group, rank = divmod(bx, self.cluster_blocks)
        c0 = group * self.group_cols + rank * self.cols_per_block
        return 0, t_rows, c0, c0 + self.cols_per_block


def _power_of_two(what: str, v: int) -> None:
    if v < 1 or v & (v - 1):
        raise ValueError(f"chained_gather: {what} must be a power of two, got {v}")


def gather_plan(t_rows: int, cols: int, n: int, sms: int,
                cluster_blocks: int = 1, cols_per_block: int | None = None,
                row_slabs: int | None = None,
                interleaved: bool = False) -> GatherPlan:
    """The columns path's partition, a pure function of the shapes and the
    card's SM count.  ``cluster_blocks`` and ``cols_per_block`` are powers
    of two whose product divides 16 (the width is a multiple of 16, so the
    groups tile it).  Unless given, a block holds 2 columns where they fit
    and 1 where not, and ``row_slabs`` fills the SMs once, as far as every
    block still gets one full pass of its threads.  Raises where the owned
    columns do not fit a block."""
    if cols_per_block is None:
        cols_per_block = 2 if t_rows * 8 <= GATHER_BLOCK_BYTES and cluster_blocks <= 8 else 1
    _power_of_two("cluster_blocks", cluster_blocks)
    _power_of_two("cols_per_block", cols_per_block)
    group_cols = cluster_blocks * cols_per_block
    if GATHER_COLS % group_cols:
        raise ValueError("chained_gather: a cluster owns at most "
                         f"{GATHER_COLS} columns, got {group_cols}")
    if t_rows < cluster_blocks:
        raise ValueError("chained_gather: the table needs a row for every block of a cluster")
    if t_rows * cols_per_block * 4 > GATHER_BLOCK_BYTES:
        raise ValueError(
            f"chained_gather: {cols_per_block} column(s) of {t_rows} rows do not fit "
            f"a block's {GATHER_BLOCK_BYTES} bytes of shared memory")
    if row_slabs is None:
        blocks_per_slab = cols // group_cols * cluster_blocks
        per_pass = GATHER_COLUMNS_THREADS * GATHER_COLUMNS_CHAINS
        row_slabs = max(1, min(sms // blocks_per_slab,
                               -(-n * cols_per_block // per_pass)))
    return GatherPlan(cols_per_block, cluster_blocks, row_slabs,
                      max(1, -(-n // row_slabs)), interleaved)


class SmemPlan(NamedTuple):
    """How the smem path cuts an (N, L) gather from a (T, L) table, T <=
    ``GATHER_SMEM_ROWS``, into blocks.  A block owns ``cols_per_block``
    adjacent columns (2, 4, 8 or 16) and keeps ``copies`` of each,
    so that a row of its shared memory always holds 16 words, one per lane
    of a half-warp: word (copy q, row r, column j) lies at ``word(q, r,
    j)``.  ``row_slabs`` blocks share a column group, each taking
    ``rows_per_slab`` rows of idx; ``cluster_blocks`` of them (1: a plain
    launch) form a thread-block cluster and share one staging pass: each
    loads ``1 / cluster_blocks`` of the table's rows and writes them to all."""
    cols_per_block: int
    cluster_blocks: int
    row_slabs: int
    rows_per_slab: int

    @property
    def copies(self) -> int:
        return GATHER_COLS // self.cols_per_block

    def smem_bytes(self, t_rows: int) -> int:
        return t_rows * GATHER_COLS * 4

    def grid(self, cols: int) -> tuple[int, int]:
        return (self.row_slabs, cols // self.cols_per_block)

    def word(self, copy: int, row: int, col: int) -> int:
        """Where a block keeps copy ``copy`` of row ``row`` of its column
        ``col``, in 4-byte words from the start of its shared memory."""
        return row * GATHER_COLS + copy * self.cols_per_block + col

    def block_extent(self, bx: int, by: int, n: int) -> tuple[int, int, int, int]:
        """(row_begin, row_end, col_begin, col_end) of idx and out that block
        (bx, by) of the grid takes, as the kernel computes it."""
        r0 = min(n, bx * self.rows_per_slab)
        return (r0, min(n, r0 + self.rows_per_slab),
                by * self.cols_per_block, (by + 1) * self.cols_per_block)

    def staged_rows(self, bx: int, t_rows: int) -> tuple[int, int]:
        """The rows of the table that block ``bx`` loads (and writes to every
        block of its cluster)."""
        share = t_rows // self.cluster_blocks
        rank = bx % self.cluster_blocks
        return rank * share, (rank + 1) * share


def smem_plan(t_rows: int, cols: int, n: int, sms: int,
              cols_per_block: int = GATHER_SMEM_COLS_PER_BLOCK,
              cluster_blocks: int = 1, row_slabs: int | None = None) -> SmemPlan:
    """The smem path's partition, a pure function of the shapes and the
    card's SM count.  Unless given, ``row_slabs`` fills the SMs once (whole
    clusters only), with at most one slab a row.  The shared memory is 16
    words a row of the table whatever ``cols_per_block`` is: a shorter table
    leaves the rest unused, it does not get more copies.  Raises where the
    table does not fit a block or the cluster is larger than the card takes
    everywhere."""
    _power_of_two("cols_per_block", cols_per_block)
    _power_of_two("cluster_blocks", cluster_blocks)
    if not 2 <= cols_per_block <= GATHER_COLS:
        raise ValueError(f"chained_gather: a block owns 2 to {GATHER_COLS} columns, "
                         f"got {cols_per_block}")
    if cluster_blocks > min(GATHER_SMEM_MAX_CLUSTER, t_rows):
        raise ValueError(
            f"chained_gather: a cluster of {cluster_blocks} blocks is more than "
            f"{GATHER_SMEM_MAX_CLUSTER} or than the table's {t_rows} rows")
    if t_rows * GATHER_COLS * 4 > GATHER_BLOCK_BYTES:
        raise ValueError(
            f"chained_gather: {GATHER_COLS} words a row of {t_rows} rows do not fit "
            f"a block's {GATHER_BLOCK_BYTES} bytes of shared memory")
    if row_slabs is None:
        groups = cols // cols_per_block
        row_slabs = max(1, min(n, sms // groups)) // cluster_blocks * cluster_blocks
        row_slabs = max(row_slabs, cluster_blocks)
    elif row_slabs < 1 or row_slabs % cluster_blocks:
        raise ValueError(f"chained_gather: {row_slabs} row slabs are not whole clusters "
                         f"of {cluster_blocks}")
    return SmemPlan(cols_per_block, cluster_blocks, row_slabs, max(1, -(-n // row_slabs)))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# Each path's own plan for (T, L, N, SM count), computed once a shape.
_own_gather_plan = functools.lru_cache(maxsize=64)(gather_plan)
_own_smem_plan = functools.lru_cache(maxsize=64)(smem_plan)


def check_gather_plan(path: str, plan, t_rows: int, n: int) -> None:
    """Raise ``ValueError`` unless ``plan`` (a ``SmemPlan`` on the smem
    path, a ``GatherPlan`` on the columns path, none on l2) is one the
    kernel of ``path`` can run on a table of ``t_rows`` rows and ``n`` rows
    of idx.  Needs no card."""
    want = {"smem": SmemPlan, "columns": GatherPlan}.get(path)
    if want is None or not isinstance(plan, want):
        raise ValueError(f"chained_gather: the {path} path does not take {plan!r}")
    fits = plan.smem_bytes(t_rows) <= GATHER_BLOCK_BYTES
    if path == "columns":
        fits = fits and GATHER_COLS % plan.group_cols == 0
    else:
        fits = (fits and plan.cols_per_block in (2, 4, 8, 16)
                and plan.cluster_blocks <= min(GATHER_SMEM_MAX_CLUSTER, t_rows)
                and plan.row_slabs % plan.cluster_blocks == 0)
    if not fits or plan.row_slabs * plan.rows_per_slab < n:
        raise ValueError(f"chained_gather: {plan} cannot hold a table of {t_rows} rows "
                         f"and {n} rows of idx")


def chained_gather(table: torch.Tensor, idx: torch.Tensor, rounds: int,
                   path: str | None = None,
                   plan: GatherPlan | SmemPlan | None = None) -> torch.Tensor:
    """Launch T2-T4 (``csrc/gather.cu``): ``rounds`` chained lookups
    ``v = table[idx[i, j], j]``, ``idx = |idx + int(v) + k| % T``, summing
    ``v``.  ``table`` (T, L) float32 or int32, T a power of two, L a
    multiple of 16, 16-byte aligned; ``idx`` (N, L) int32 with entries in
    [0, T).  ``path`` forces one of ``GATHER_PATHS`` (default:
    ``gather_path(T)``) and raises if that path cannot hold the table;
    ``plan`` replaces the path's own ``smem_plan`` or ``gather_plan`` (the
    probe's variant tables) and raises if the kernel cannot run it.  A
    launch the card refuses raises; no other path is tried."""
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
    t_rows, cols = table.shape
    path = check_gather_path(t_rows, path)
    if plan is not None:
        check_gather_plan(path, plan, t_rows, idx.shape[0])
    else:
        own = {"smem": _own_smem_plan, "columns": _own_gather_plan}.get(path)
        plan = (GatherPlan(0, 0, 0, 0) if own is None else
                own(t_rows, cols, idx.shape[0], _sm_count(table.get_device())))
    lib = load()
    out = table.new_empty(idx.shape)
    err = _launch(
        lib.vulcan_chained_gather, table, table.data_ptr(), idx.data_ptr(),
        out.data_ptr(), idx.shape[0], t_rows, cols, rounds,
        int(table.dtype == torch.int32), GATHER_PATHS.index(path),
        plan.cols_per_block, plan.cluster_blocks, plan.row_slabs,
        plan.rows_per_slab, int(path == "columns" and plan.interleaved),
    )
    _raise_on(err, f"chained_gather ({path})")
    return out


def gather_max_clusters(t_rows: int, cols: int, plan: GatherPlan | SmemPlan) -> int:
    """How many of ``plan``'s clusters the current card runs at once
    (``cudaOccupancyMaxActiveClusters``): a plan of more runs in waves."""
    path = "smem" if isinstance(plan, SmemPlan) else "columns"
    got = load().vulcan_gather_max_clusters(
        GATHER_PATHS.index(path), t_rows, cols, plan.cols_per_block,
        plan.cluster_blocks, plan.row_slabs, plan.rows_per_slab)
    _raise_on(-min(got, 0), "gather_max_clusters")
    return got


def check_gather_path(t_rows: int, path: str | None) -> str:
    """The path a table of ``t_rows`` rows takes: ``gather_path`` unless
    ``path`` forces one; raises if the forced path cannot hold the table."""
    if path is None:
        return gather_path(t_rows)
    if path not in GATHER_PATHS:
        raise ValueError(f"chained_gather: path must be one of {GATHER_PATHS}, got {path!r}")
    if (path == "smem" and t_rows > GATHER_SMEM_ROWS) or (
            path == "columns" and t_rows * 4 > GATHER_BLOCK_BYTES):
        raise ValueError(f"chained_gather: the {path} path cannot hold a table of "
                         f"{t_rows} rows")
    return path


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


# The track's Gauss-Newton kernels H1a-H1c (csrc/icp.cu).  A pose is a (16,)
# float32 vector on the card, [R row-major (9), t (3), err, inliers, level
# score, geometric score]; the model side a (15,) one, [world-to-camera R
# (9), t (3), vertex origin (3)].  H1b (and ``icp_rows_solve``, H1b with
# H1c on its rank 0) is one thread-block cluster of ICP_ROWS_CLUSTER CTAs
# of ICP_ROWS_THREADS, whatever the pixel count: the CTAs' sums meet in
# rank order through distributed shared memory.  H1a takes
# ICP_ASSOC_PIXELS pixels a thread in blocks of ICP_ASSOC_THREADS.
ICP_ASSOC_THREADS = 256             # csrc/icp.cu kAssocThreads
ICP_ASSOC_PIXELS = 2                # csrc/icp.cu kAssocPixels
ICP_SOLVE_THREADS = 64              # csrc/icp.cu kSolveThreads: two warps
ICP_ROWS_THREADS = 512              # csrc/icp.cu kRowsThreads
ICP_ROWS_CLUSTER = 16               # csrc/icp.cu kRowsCluster
ICP_SUMS = 29                       # csrc/icp.cu kSums: 21 of H, 6 of b, error, count
ICP_POSE = 16
ICP_MODEL = 15


def _check_vector(x: torch.Tensor, what: str, size: int) -> None:
    _check(x, what, ndim=1)
    if x.shape[0] != size:
        raise ValueError(f"{what}: expected ({size},), got {tuple(x.shape)}")


def _check_live(depth: torch.Tensor, what: str, *planes, vectors=()) -> None:
    """The live maps of one level: (h, w) planes and (h, w, 3) vectors,
    all float32, contiguous and on the card."""
    for k, x in enumerate((depth, *planes)):
        _check(x, f"{what} plane {k}")
        if x.shape != depth.shape:
            raise ValueError(f"{what}: plane {k} is {tuple(x.shape)}, not {tuple(depth.shape)}")
    for k, x in enumerate(vectors):
        _check(x, f"{what} vector map {k}", ndim=3)
        if x.shape != (*depth.shape, 3):
            raise ValueError(f"{what}: vector map {k} is {tuple(x.shape)}")


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def icp_associate(depth: torch.Tensor, vertices: torch.Tensor, pose: torch.Tensor,
                  model: torch.Tensor, maps: tuple[torch.Tensor, ...],
                  words: tuple[torch.Tensor, torch.Tensor] | None,
                  camera: tuple[float, float, float, float], depth_min: float,
                  depth_max: float, geometric: bool, photo: bool):
    """Launch H1a: the live (h, w) level at ``pose`` against the model maps
    ``(vpack1, vpack2, npack)`` (and the photometric ``words``).  Returns
    ``((v_m, n_m, ok) or None, (i_m0, gu, gv, u0, v0, ok_c) or None)``.

    A programmatic dependent launch: it reads ``depth`` and ``vertices``
    before the kernel ahead of it in the stream has finished (everything
    else after), so that kernel must not write them.  ``track`` launches it
    after a solve or after ``level_inputs``, whose last kernel writes the
    model vector."""
    if not (geometric or photo) or (photo and words is None):
        raise ValueError("icp_associate: needs a term, and the words for the photometric one")
    _check_live(depth, "icp_associate live", vectors=(vertices,))
    _check_vector(pose, "icp_associate pose", ICP_POSE)
    _check_vector(model, "icp_associate model", ICP_MODEL)
    hm, wm = maps[0].shape
    for k, m in enumerate((*maps, *(words or ()))):
        _check(m, f"icp_associate model map {k}", (torch.int32,))
        if m.shape != (hm, wm):
            raise ValueError(f"icp_associate: model map {k} is {tuple(m.shape)}")
    lib = load()
    h, w = depth.shape
    corr = samples = None
    if geometric:
        corr = (vertices.new_empty((h, w, 3)), vertices.new_empty((h, w, 3)),
                torch.empty((h, w), dtype=torch.bool, device=depth.device))
    if photo:
        samples = (*depth.new_empty((5, h, w)).unbind(0),
                   torch.empty((h, w), dtype=torch.bool, device=depth.device))
    wa, wb = words if photo else (None, None)
    err = _launch(
        lib.vulcan_icp_associate, depth, depth.data_ptr(), vertices.data_ptr(),
        pose.data_ptr(), model.data_ptr(), *(m.data_ptr() for m in maps), _ptr(wa),
        _ptr(wb), h * w, hm, wm, *camera, depth_min, depth_max, int(geometric),
        int(photo), *((c.data_ptr() for c in corr) if geometric else (None,) * 3),
        _ptr(samples[0]) if photo else None, _ptr(samples[5]) if photo else None,
        launch_counter(depth, "icp_associate"),
    )
    _raise_on(err, "icp_associate")
    return corr, samples


def _check_rows(what: str, depth, vertices, normals, intensity, pose, model, corr,
                samples, geometric: bool, photo: bool) -> None:
    """The inputs of a rows pass (H1b, ``icp_rows_solve``): the live level,
    the pose and model vectors, each present term's correspondences or
    samples."""
    if not (geometric or photo) or (geometric and corr is None) or (
            photo and (samples is None or intensity is None)):
        raise ValueError(f"{what}: a term lacks its correspondences or samples")
    _check_live(depth, f"{what} live", *((intensity,) if photo else ()),
                vectors=(vertices, normals))
    _check_vector(pose, f"{what} pose", ICP_POSE)
    _check_vector(model, f"{what} model", ICP_MODEL)
    if geometric:
        _check_live(depth, f"{what} correspondences", vectors=corr[:2])
        _check(corr[2], f"{what} ok", (torch.bool,))
    if photo:
        _check_live(depth, f"{what} samples", *samples[:5])
        _check(samples[5], f"{what} sample ok", (torch.bool,))
    for ok in (corr[2] if geometric else None, samples[5] if photo else None):
        if ok is not None and ok.shape != depth.shape:
            raise ValueError(f"{what}: a validity mask is {tuple(ok.shape)}")


def icp_rows(depth: torch.Tensor, vertices: torch.Tensor, normals: torch.Tensor,
             intensity: torch.Tensor | None, pose: torch.Tensor, model: torch.Tensor,
             corr, samples, camera: tuple[float, float, float, float],
             scalars: tuple[float, ...], geometric: bool, photo: bool,
             live_normals: bool) -> torch.Tensor:
    """Launch H1b: the (2, 29) stacked sums, geometric then photometric
    (zeros for an absent term), of the live level's rows at ``pose``.
    ``scalars``: depth_min, depth_max, icp_dist_thresh ** 2,
    icp_normal_thresh, icp_huber_delta, rgb_huber_delta, rgb_weight."""
    _check_rows("icp_rows", depth, vertices, normals, intensity, pose, model, corr,
                samples, geometric, photo)
    lib = load()
    n = depth.numel()
    out = depth.new_empty((2, ICP_SUMS))
    err = _launch(
        lib.vulcan_icp_rows, depth, depth.data_ptr(), vertices.data_ptr(),
        normals.data_ptr(), _ptr(intensity), pose.data_ptr(), model.data_ptr(),
        *((c.data_ptr() for c in corr) if geometric else (None,) * 3),
        *((s.data_ptr() for s in samples) if photo else (None,) * 6),
        n, *camera, *scalars, int(geometric), int(photo), int(live_normals),
        out.data_ptr(), launch_counter(depth, "icp_rows"),
    )
    _raise_on(err, "icp_rows")
    return out


def icp_solve(sums: torch.Tensor, pose: torch.Tensor, damping: float,
              geometric: bool, photo: bool, detect: bool) -> torch.Tensor:
    """Launch H1c on the (2, 29) sums: the next (16,) pose vector (a GN
    step), or with ``detect`` the level's two observability scores in its
    last two entries."""
    if not (geometric or photo):
        raise ValueError("icp_solve: needs a term")
    _check(sums, "icp_solve sums")
    if sums.shape != (2, ICP_SUMS):
        raise ValueError(f"icp_solve: expected sums of (2, {ICP_SUMS}), got {tuple(sums.shape)}")
    _check_vector(pose, "icp_solve pose", ICP_POSE)
    lib = load()
    out = pose.new_empty(ICP_POSE)
    err = _launch(lib.vulcan_icp_solve, sums, sums.data_ptr(), pose.data_ptr(), damping,
                  int(geometric), int(photo), int(detect), out.data_ptr(),
                  launch_counter(sums, "icp_solve"))
    _raise_on(err, "icp_solve")
    return out


def icp_rows_solve(depth: torch.Tensor, vertices: torch.Tensor, normals: torch.Tensor,
                   intensity: torch.Tensor | None, pose: torch.Tensor, model: torch.Tensor,
                   corr, samples, camera: tuple[float, float, float, float],
                   scalars: tuple[float, ...], damping: float, geometric: bool,
                   photo: bool, detect: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch H1b and H1c as one kernel: the (2, 29) sums of the live
    level's rows at ``pose`` (``icp_rows``; with ``detect`` the detector's,
    from the live normals) and the next (16,) pose vector solved from them
    on the cluster's rank 0 (``icp_solve``).  Returns ``(sums, pose)``."""
    _check_rows("icp_rows_solve", depth, vertices, normals, intensity, pose, model, corr,
                samples, geometric, photo)
    lib = load()
    sums = depth.new_empty((2, ICP_SUMS))
    out = pose.new_empty(ICP_POSE)
    err = _launch(
        lib.vulcan_icp_rows_solve, depth, depth.data_ptr(), vertices.data_ptr(),
        normals.data_ptr(), _ptr(intensity), pose.data_ptr(), model.data_ptr(),
        *((c.data_ptr() for c in corr) if geometric else (None,) * 3),
        *((s.data_ptr() for s in samples) if photo else (None,) * 6),
        depth.numel(), *camera, *scalars, damping, int(geometric), int(photo),
        int(detect), sums.data_ptr(), out.data_ptr(),
        launch_counter(depth, "icp_rows_solve"),
    )
    _raise_on(err, "icp_rows_solve")
    return sums, out


# Conditional nodes of a graph capture (csrc/graph.cu; utils/sync.py).
def graph_prepare(device: torch.device) -> None:
    """Load the conditional nodes' one-thread kernels on ``device`` and make
    the launch counters, before a capture."""
    x = torch.empty(0, device=device)
    launch_counter(x, "graph_while")
    _raise_on(_launch(load().vulcan_graph_prepare, x), "graph_prepare")


_graph_streams: dict = {}


def graph_streams(device: torch.device, n: int) -> list:
    """``n`` streams of the node bodies' own on ``device`` (created once; a
    capture may not create streams), as ``torch.cuda.ExternalStream``s."""
    have = _graph_streams.setdefault(device.index, [])
    while len(have) < n:
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            _raise_on(load().vulcan_graph_stream(ctypes.byref(handle)), "graph_stream")
        have.append(torch.cuda.ExternalStream(handle.value, device=device))
    return have[:n]


def _check_scalar(x: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if x.dtype != dtype or x.ndim != 0 or not x.is_cuda:
        raise ValueError(f"{what}: expected a 0-d {dtype} CUDA tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)} on {x.device}")


def graph_while(count: torch.Tensor, bound: int, offset: torch.Tensor) -> tuple[int, int]:
    """Add a WHILE node over the 0-d int32 ``count`` (capped at ``bound``) to
    the graph that the current stream is capturing, after a launch that sets
    the 0-d int64 ``offset`` to 0.  Returns the node's handle and its body
    graph (``graph_body_begin``), whose last node is ``graph_while_next``."""
    _check_scalar(count, torch.int32, "graph_while count")
    _check_scalar(offset, torch.int64, "graph_while offset")
    handle, body = ctypes.c_ulonglong(), ctypes.c_void_p()
    _raise_on(_launch(load().vulcan_graph_while, count, count.data_ptr(), bound,
                      offset.data_ptr(), launch_counter(count, "graph_while"),
                      ctypes.byref(handle), ctypes.byref(body)), "graph_while")
    return handle.value, body.value


def graph_while_next(handle: int, count: torch.Tensor, bound: int, chunk: int,
                     offset: torch.Tensor) -> None:
    """The last node of a WHILE body, on the current (body) stream: ``offset``
    moves on by ``chunk`` and the loop goes on while it is below
    ``min(count, bound)``."""
    _raise_on(_launch(load().vulcan_graph_while_next, count, handle, count.data_ptr(), bound,
                      chunk, offset.data_ptr(), launch_counter(count, "graph_while_next")),
              "graph_while_next")


def graph_cond(pred: torch.Tensor, size: int) -> list[int]:
    """Add an IF/ELSE node (``size`` 2; 1: a plain IF node) on the 0-d bool
    ``pred`` to the graph that the current stream is capturing.  Returns its
    body graphs: the true branch's, then the false one's."""
    _check_scalar(pred, torch.bool, "graph_cond pred")
    bodies = (ctypes.c_void_p * size)()
    _raise_on(_launch(load().vulcan_graph_cond, pred, pred.data_ptr(), size,
                      launch_counter(pred, "graph_ifelse"), ctypes.byref(bodies)),
              "graph_cond")
    return list(bodies)


def graph_body_begin(graph: int, body: torch.cuda.Stream) -> None:
    """Start capturing the stream ``body`` into a conditional node's body
    graph."""
    _raise_on(load().vulcan_graph_body_begin(graph, body.cuda_stream), "graph_body_begin")


def graph_body_end(body: torch.cuda.Stream) -> None:
    """End the capture of a conditional node's body."""
    _raise_on(load().vulcan_graph_body_end(body.cuda_stream), "graph_body_end")


# Span marks (csrc/trace.cu; utils/timing.py SpanTracer).
TRACE_FIRST = 1     # the frame's first mark: clears and tags the frame's row
TRACE_LAST = 2      # the frame's last mark: advances the frame counter


def trace_prepare(device: torch.device) -> None:
    """Load the mark's kernel on ``device`` and make the launch counters,
    before a capture."""
    x = torch.empty(0, device=device)
    launch_counter(x, "trace_mark")
    _raise_on(_launch(load().vulcan_trace_prepare, x), "trace_prepare")


def trace_mark(ring: torch.Tensor, frame: torch.Tensor, slot: int, flags: int = 0,
               counted: bool = True) -> None:
    """One launch on the current stream that writes the card's
    ``%globaltimer`` into slot ``slot`` of the row of frame ``frame`` (a 0-d
    int64) of the (frames, width) int64 ``ring``; ``flags``: ``TRACE_FIRST``,
    ``TRACE_LAST``.  ``counted``: count it as ``trace_mark`` (the clock's
    calibration marks are not)."""
    _check(ring, "trace_mark ring", dtypes=(torch.int64,))
    _check_scalar(frame, torch.int64, "trace_mark frame")
    frames, width = ring.shape
    if not 0 <= slot < width - 1:
        raise ValueError(f"trace_mark: slot {slot} outside a row of {width - 1} marks")
    launches = launch_counter(ring, "trace_mark") if counted else None
    _raise_on(_launch(load().vulcan_trace_mark, ring, ring.data_ptr(), frame.data_ptr(), width,
                      frames, slot, flags, launches), "trace_mark")


# The march's range image (csrc/range_image.cu): the stamps as one
# thread-block cluster, then the upsample.  The three coarse images stay in
# each CTA's shared memory while they fit RANGE_SMEM_BYTES ("smem"), else in
# a scratch in global memory ("global"; ``range_image_path``).
RANGE_SMEM_BYTES = GATHER_BLOCK_BYTES   # csrc/range_image.cu kSmemBytes


def range_image_path(cells: int) -> str:
    """"smem" or "global": where the stamp kernel keeps three coarse images
    of ``cells`` cells, by their size alone."""
    return "smem" if 3 * cells * 4 <= RANGE_SMEM_BYTES else "global"


def range_image(z_min: torch.Tensor, z_max: torch.Tensor, footprint: tuple[torch.Tensor, ...],
                stampable: torch.Tensor, num_visible: torch.Tensor,
                any_overflow: torch.Tensor, g_min: torch.Tensor, g_max: torch.Tensor,
                coarse: tuple[int, int], stamp: int, scale: int,
                size: tuple[int, int]) -> torch.Tensor:
    """Launch R1: the visible rows' stamps into the (hc, wc) = ``coarse``
    min/max range images (``range_stamp``), then their nearest upsample by
    ``scale`` to ``size`` = (H, W) (``range_expand``).  The rows: float32
    ``z_min``/``z_max``, the int64 ``footprint`` (u_min, u_max, v_min,
    v_max) in coarse cells and the bool ``stampable``, all (V,); the 0-d
    int32 ``num_visible``, bool ``any_overflow`` and float32 ``g_min``,
    ``g_max``.  Returns the (3, H, W) float32 t_min, t_first_max, t_max."""
    if len(footprint) != 4:
        raise ValueError("range_image: the footprint is u_min, u_max, v_min, v_max")
    rows = z_min.shape[0]
    for x, what, dtype in ((z_min, "z_min", torch.float32), (z_max, "z_max", torch.float32),
                           *((f, "footprint", torch.int64) for f in footprint),
                           (stampable, "stampable", torch.bool)):
        _check(x, f"range_image {what}", (dtype,), ndim=1)
        if x.shape[0] != rows:
            raise ValueError(f"range_image: {what} has {x.shape[0]} rows, not {rows}")
    _check_scalar(num_visible, torch.int32, "range_image num_visible")
    _check_scalar(any_overflow, torch.bool, "range_image any_overflow")
    _check_scalar(g_min, torch.float32, "range_image g_min")
    _check_scalar(g_max, torch.float32, "range_image g_max")
    if any(x.device != z_min.device for x in (z_max, *footprint, stampable, num_visible,
                                              any_overflow, g_min, g_max)):
        raise ValueError("range_image: the rows and scalars lie on different devices")
    (hc, wc), (h, w) = coarse, size
    if not (stamp >= 1 and scale >= 1 and hc == -(-h // scale) and wc == -(-w // scale)):
        raise ValueError(f"range_image: a ({hc}, {wc}) coarse image does not cover "
                         f"({h}, {w}) at scale {scale}, or the stamp {stamp} is empty")
    lib = load()
    cells = hc * wc
    keys = (None if range_image_path(cells) == "smem" else
            torch.empty((3, cells), dtype=torch.int32, device=z_min.device))
    images = z_min.new_empty((3, cells))
    err = _launch(
        lib.vulcan_range_stamp, z_min, z_min.data_ptr(), z_max.data_ptr(),
        *(f.data_ptr() for f in footprint), stampable.data_ptr(), num_visible.data_ptr(),
        any_overflow.data_ptr(), g_min.data_ptr(), g_max.data_ptr(), rows, hc, wc, stamp,
        _ptr(keys), images.data_ptr(), launch_counter(z_min, "range_stamp"),
    )
    _raise_on(err, "range_stamp")
    out = z_min.new_empty((3, h, w))
    err = _launch(lib.vulcan_range_expand, z_min, images.data_ptr(), out.data_ptr(), h, w,
                  hc, wc, scale, launch_counter(z_min, "range_expand"))
    _raise_on(err, "range_expand")
    return out


# I1, the integrate layer (csrc/integrate.cu): one launch fuses a frame into
# every listed block, in place.
INTEGRATE_BLOCK_VOXELS = 512        # csrc/integrate.cu kThreads: a block's voxels
INTEGRATE_MAX_SLOTS = 512           # csrc/integrate.cu kMaxSlots


class IntegrateScalars(NamedTuple):
    """I1's ``Config`` scalars, each as the plain version's PyTorch ops
    round it to float32 on the card (``sparse.i1_scalars``)."""

    voxel_size: float
    depth_scale: float      # 1 / depth_raw_scale
    depth_min: float
    depth_max: float
    mu: float               # trunc_dist
    inv_mu: float           # float32(1 / mu): what a tensor over a Python float multiplies by
    max_weight: float
    band: float             # blocks.surfel_band
    half_band: float
    eps: float              # mesh_dirty_eps
    gate: bool              # mesh_dirty_eps > 0: else every fused block is marked


def integrate(ids: torch.Tensor, count: torch.Tensor, pose: torch.Tensor,
              image: torch.Tensor, block_coords: torch.Tensor, voxels: tuple[torch.Tensor, ...],
              surfels: tuple[torch.Tensor, ...], surf_overflow: torch.Tensor,
              camera: tuple[float, float, float, float], scalars: IntegrateScalars) -> None:
    """Launch I1: fuse the packed (h, w) int32 depth16 | rgb565 ``image``
    at the world-to-camera ``pose`` ((12,) float32: R row-major, t) into the
    blocks listed in the int32 ``ids`` below the 0-d int32 ``count`` (read on
    the card; ids <= 0 are skipped), in place: ``voxels`` = (tsdf, weight,
    colorpack), each (num_blocks, 512); ``surfels`` = (surfpack (num_blocks,
    slots), surf_count, mesh_dirty); the dropped surfels are added to the
    0-d int32 ``surf_overflow``."""
    tsdf, weight, colorpack = voxels
    surfpack, surf_count, mesh_dirty = surfels
    nb = tsdf.shape[0]
    _check(ids, "integrate ids", (torch.int32,), ndim=1)
    _check_scalar(count, torch.int32, "integrate count")
    _check_vector(pose, "integrate pose", 12)
    _check(image, "integrate image", (torch.int32,))
    _check(block_coords, "integrate block_coords", (torch.int32,))
    for x, what, dtype in ((tsdf, "tsdf", torch.float32), (weight, "weight", torch.float32),
                           (colorpack, "colorpack", torch.int32)):
        _check(x, f"integrate {what}", (dtype,))
        if x.shape != (nb, INTEGRATE_BLOCK_VOXELS):
            raise ValueError(f"integrate: {what} is {tuple(x.shape)}, not "
                             f"({nb}, {INTEGRATE_BLOCK_VOXELS})")
    _check(surfpack, "integrate surfpack", (torch.int32,))
    _check(surf_count, "integrate surf_count", (torch.int32,), ndim=1)
    _check(mesh_dirty, "integrate mesh_dirty", (torch.bool,), ndim=1)
    _check_scalar(surf_overflow, torch.int32, "integrate surf_overflow")
    slots = surfpack.shape[1]
    if not (block_coords.shape == (nb, 3) and surfpack.shape[0] == nb
            and surf_count.shape == (nb,) and mesh_dirty.shape == (nb,)):
        raise ValueError("integrate: the volume's arrays disagree on the block count")
    if not 1 <= slots <= INTEGRATE_MAX_SLOTS:
        raise ValueError(f"integrate: {slots} surfel slots a block, at most "
                         f"{INTEGRATE_MAX_SLOTS}")
    tensors = (ids, count, pose, image, block_coords, *voxels, *surfels, surf_overflow)
    if any(x.device != tsdf.device for x in tensors):
        raise ValueError("integrate: the list, the frame and the volume lie on different devices")
    h, w = image.shape
    *floats, gate = scalars
    err = _launch(
        load().vulcan_integrate, tsdf, ids.data_ptr(), count.data_ptr(),
        block_coords.data_ptr(), pose.data_ptr(), image.data_ptr(), ids.shape[0], h, w,
        slots, int(gate), *camera, *floats, tsdf.data_ptr(), weight.data_ptr(),
        colorpack.data_ptr(), surfpack.data_ptr(), surf_count.data_ptr(),
        mesh_dirty.data_ptr(), surf_overflow.data_ptr(), launch_counter(tsdf, "integrate"),
    )
    _raise_on(err, "integrate")


# S1, the surfel splat's z-buffer (csrc/splat_zbuf.cu): one launch splats every
# listed block's surfels into a buffer by integer atomics (two for rgb).
SPLAT_ZBUF_MODES = ("depth", "luma", "rgb")   # csrc/splat_zbuf.cu Mode
SPLAT_MAX_SLOTS = 512               # csrc/splat_zbuf.cu kMaxSlots


class SplatScalars(NamedTuple):
    """S1's ``Config`` scalars (the wrapper rounds each to float32, as the
    plain version's ops round a Python float on the card)."""

    voxel_size: float
    mu: float               # trunc_dist
    ray_near: float
    ray_far: float
    zq_scale: float         # splat._ZQ_MAX / ray_far: a depth's quantization step
    cull: bool              # splat_backface_cull


def splat_zbuf(out: torch.Tensor, mode: str, ids: torch.Tensor, count: torch.Tensor,
               surfels: tuple[torch.Tensor, torch.Tensor], colorpack: torch.Tensor,
               block_coords: torch.Tensor, frame: torch.Tensor,
               camera: tuple[float, float, float, float], scalars: SplatScalars,
               zref: torch.Tensor | None = None) -> None:
    """Launch S1 once: splat the surfels of the blocks listed in the int32
    ``ids`` below the 0-d int32 ``count`` (read on the card; ids <= 0 and
    blocks without a surfel are skipped) at the (15,) float32 ``frame``
    (world-to-camera R row-major, t, the camera centre in the world) into
    ``out``, an (H, W) buffer the caller has filled, in place: in ``mode``
    "depth" a float32 min (fill +inf), "luma" the int32 packed-word min
    (fill ``splat._LUMA_EMPTY``), "rgb" the int32 rgb888 max (fill -1) of
    the surfels whose depth is within 1e-5 m of the float32 ``zref``, the
    finished depth buffer.  ``surfels`` = (surfpack (num_blocks, slots),
    surf_count); ``colorpack`` (num_blocks, 512)."""
    surfpack, surf_count = surfels
    if mode not in SPLAT_ZBUF_MODES:
        raise ValueError(f"splat_zbuf: mode must be one of {SPLAT_ZBUF_MODES}, got {mode!r}")
    slots = surfpack.shape[-1]
    if not 1 <= slots <= SPLAT_MAX_SLOTS:
        raise ValueError(f"splat_zbuf: {slots} surfel slots a block, at most {SPLAT_MAX_SLOTS}")
    if not scalars.ray_near >= 0.0:
        raise ValueError("splat_zbuf: depths are ordered as their float32 bits, which "
                         f"needs ray_near >= 0, got {scalars.ray_near}")
    nb = surfpack.shape[0]
    _check(out, "splat_zbuf out", ((torch.float32,) if mode == "depth" else (torch.int32,)))
    _check(ids, "splat_zbuf ids", (torch.int32,), ndim=1)
    _check_scalar(count, torch.int32, "splat_zbuf count")
    _check(surfpack, "splat_zbuf surfpack", (torch.int32,))
    _check(surf_count, "splat_zbuf surf_count", (torch.int32,), ndim=1)
    _check(colorpack, "splat_zbuf colorpack", (torch.int32,))
    _check(block_coords, "splat_zbuf block_coords", (torch.int32,))
    _check_vector(frame, "splat_zbuf frame", 15)
    if not (surf_count.shape == (nb,) and colorpack.shape == (nb, INTEGRATE_BLOCK_VOXELS)
            and block_coords.shape == (nb, 3)):
        raise ValueError("splat_zbuf: the volume's arrays disagree on the block count")
    if (zref is None) != (mode != "rgb"):
        raise ValueError("splat_zbuf: the rgb mode, and it alone, takes zref")
    if zref is not None:
        _check(zref, "splat_zbuf zref")
        if zref.shape != out.shape:
            raise ValueError(f"splat_zbuf: zref is {tuple(zref.shape)}, not {tuple(out.shape)}")
    tensors = (ids, count, surfpack, surf_count, colorpack, block_coords, frame,
               *(() if zref is None else (zref,)))
    if any(x.device != out.device for x in tensors):
        raise ValueError("splat_zbuf: the list, the pose and the volume lie on different devices")
    h, w = out.shape
    *floats, cull = scalars
    err = _launch(
        load().vulcan_splat_zbuf, out, SPLAT_ZBUF_MODES.index(mode), ids.data_ptr(),
        count.data_ptr(), surfpack.data_ptr(), surf_count.data_ptr(), colorpack.data_ptr(),
        block_coords.data_ptr(), frame.data_ptr(), _ptr(zref), ids.shape[0], slots, h, w,
        int(cull), *camera, *floats, out.data_ptr(), launch_counter(out, "splat_zbuf"),
    )
    _raise_on(err, "splat_zbuf")
