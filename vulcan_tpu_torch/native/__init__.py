"""ctypes bindings of the port's native runtime (``src/native.cpp``): PNG
probe and decode, the threaded prefetch loader, the O(n) welding PLY
writer.

The library is built with ``g++`` at first use (or ``python -m
vulcan_tpu_torch.native.build``) into ``<repo>/build/vulcan_tpu_torch_native/
<hash>/``, keyed on a hash of the source and flags, written to a temporary
name and renamed into place, so processes building at once never load a
torn file.  It links zlib alone.  A failed build raises with the
compiler's output: nothing here falls back to another decoder or writer.
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

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vulcan_tpu_torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")

# Status codes of src/native.cpp's Status enum.
_ERRORS = {
    1: "cannot open or read the file",
    2: "not a PNG file",
    3: "corrupt PNG (truncated, misordered or failing a CRC)",
    4: "PNG format not decoded (interlaced, palette, gray+alpha, or a bit "
       "depth other than 8, or 16 for gray)",
    5: "the image data does not inflate to its size",
    6: "a row names an unknown filter type",
    7: "image size differs from the expected one",
    8: "wrong kind of image for the call (depth needs gray, colour needs "
       "8-bit RGB or RGBA)",
}

_lock = threading.Lock()
_lib = None

_P = ctypes.POINTER
_F32 = _P(ctypes.c_float)
_SIGNATURES = {
    "vt_png_probe": ([ctypes.c_char_p, _P(ctypes.c_int), _P(ctypes.c_int)],
                     ctypes.c_int),
    "vt_decode_depth": ([ctypes.c_char_p, ctypes.c_float, _F32, ctypes.c_int,
                         ctypes.c_int], ctypes.c_int),
    "vt_decode_rgb": ([ctypes.c_char_p, _F32, ctypes.c_int, ctypes.c_int],
                      ctypes.c_int),
    "vt_loader_create": ([_P(ctypes.c_char_p), _P(ctypes.c_char_p), ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int], ctypes.c_void_p),
    "vt_loader_next": ([ctypes.c_void_p, _F32, _F32, _P(ctypes.c_int)],
                       ctypes.c_int),
    "vt_loader_destroy": ([ctypes.c_void_p], None),
    "vt_ply_write": ([ctypes.c_char_p, _F32, _F32, ctypes.c_long, ctypes.c_int,
                      ctypes.c_float], ctypes.c_long),
}


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libvulcan_tpu_torch_native.so"


def build() -> Path:
    """Compile the library if the hashed file is missing; return its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native runtime of vulcan_tpu_torch "
                           "is built from source at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, out.name)
        cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", lib, *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(lib, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
    return _lib


def _check(rc: int, what: str, path: str) -> None:
    if rc != 0:
        raise IOError(f"{what} failed: {_ERRORS.get(rc, f'status {rc}')}: {path}")


def _f32(a: np.ndarray):
    return a.ctypes.data_as(_F32)


def png_probe(path: str) -> tuple[int, int]:
    """(width, height) from a PNG's header."""
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(load().vt_png_probe(os.fsencode(path), ctypes.byref(w), ctypes.byref(h)),
           "png probe", path)
    return w.value, h.value


def decode_depth(path: str, width: int, height: int, scale: float = 5000.0):
    """(height, width) float32 metres: 16- or 8-bit gray over ``scale``."""
    out = np.empty((height, width), np.float32)
    _check(load().vt_decode_depth(os.fsencode(path), scale, _f32(out), width, height),
           "depth decode", path)
    return out


def decode_rgb(path: str, width: int, height: int):
    """(height, width, 3) float32 in [0, 1] from 8-bit RGB or RGBA."""
    out = np.empty((height, width, 3), np.float32)
    _check(load().vt_decode_rgb(os.fsencode(path), _f32(out), width, height),
           "rgb decode", path)
    return out


class PrefetchLoader:
    """Background-thread frame decoder with a bounded ring buffer: yields
    (depth (H, W), color (H, W, 3)) float32 arrays in order.  A frame that
    fails to decode raises ``IOError`` naming it."""

    def __init__(
        self,
        depth_paths: list[str],
        rgb_paths: list[str | None],
        width: int,
        height: int,
        depth_scale: float = 5000.0,
        capacity: int = 4,
        n_threads: int = 2,
    ):
        self._handle = None
        lib = load()
        n = len(depth_paths)
        if len(rgb_paths) != n:
            raise ValueError(f"{n} depth paths but {len(rgb_paths)} rgb paths")
        # Kept referenced: the worker threads read them until close().
        self._dp = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in depth_paths])
        self._rp = (ctypes.c_char_p * n)(
            *[os.fsencode(p) if p else None for p in rgb_paths])
        self._paths = list(depth_paths)
        self.width, self.height, self.n = width, height, n
        self._lib = lib
        self._handle = lib.vt_loader_create(
            self._dp, self._rp, n, width, height, depth_scale, capacity, n_threads)

    def __iter__(self):
        status = ctypes.c_int()
        for i in range(self.n):
            depth = np.empty((self.height, self.width), np.float32)
            color = np.empty((self.height, self.width, 3), np.float32)
            rc = self._lib.vt_loader_next(self._handle, _f32(depth), _f32(color),
                                          ctypes.byref(status))
            if rc == 1:
                return
            if rc != 0:
                _check(status.value, f"frame {i} decode", self._paths[i])
            yield depth, color

    def close(self):
        if self._handle:
            self._lib.vt_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def ply_write(
    path: str,
    positions,
    colors,
    weld: bool = True,
    weld_resolution: float = 1e-5,
) -> int:
    """Write a (T, 3, 3) triangle soup with (T, 3, 3) colours in [0, 1] as
    a binary PLY, welding vertices that round to one ``weld_resolution``
    grid point (a hash map, O(n)); returns the vertex count."""
    pos = np.ascontiguousarray(positions, np.float32)
    col = np.ascontiguousarray(colors, np.float32)
    if pos.shape != col.shape or pos.size % 9:
        raise ValueError(f"need two (T, 3, 3) arrays, got {pos.shape}, {col.shape}")
    rc = load().vt_ply_write(os.fsencode(path), _f32(pos), _f32(col), pos.size // 9,
                             int(weld), weld_resolution)
    if rc < 0:
        raise IOError(f"ply write failed: {path}")
    return int(rc)
