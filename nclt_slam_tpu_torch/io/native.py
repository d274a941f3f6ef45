"""ctypes bindings for the native host-side runtime (native/artefact_io.cpp)
(``nclt_slam_tpu/io/native.py``).

The sources are the repository's own ``native/`` directory, shared by both
packages: it is host I/O, not a device kernel.  The port builds them on
first use (g++, ``native/Makefile``'s flags) into its own
``build/native/`` (gitignored), under a temporary name renamed into place:
the JAX package builds ``native/`` in place, and neither may load the
other's half-written file.  Every entry point has a pure-Python/numpy
fallback so the port works without a toolchain; tests assert the two
paths agree exactly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO / "native"
_LIB_PATH = _REPO / "build" / "native" / "libartefact_io.so"
_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
_lib = None
_build_failed = False


def _build():
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    subprocess.run([os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", str(tmp),
                    str(_NATIVE_DIR / "artefact_io.cpp")],
                   check=True, capture_output=True)
    os.replace(tmp, _LIB_PATH)


def _get_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        if not _LIB_PATH.is_file():
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        f4p = np.ctypeslib.ndpointer(np.float32, flags="C")
        f8p = np.ctypeslib.ndpointer(np.float64, flags="C")
        i4p = np.ctypeslib.ndpointer(np.int32, flags="C")

        lib.pgm_decode.restype = ctypes.c_long
        lib.pgm_decode.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
        lib.pgm_encode.restype = ctypes.c_long
        lib.pgm_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                   ctypes.c_long]
        lib.velodyne_unpack.restype = ctypes.c_long
        lib.velodyne_unpack.argtypes = [u8p, ctypes.c_long, f4p, f4p]
        lib.bresenham_update.restype = None
        lib.bresenham_update.argtypes = [
            f4p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i4p, i4p, ctypes.c_long,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float]
        lib.csv_parse_floats.restype = ctypes.c_long
        lib.csv_parse_floats.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                         f8p, ctypes.c_long, ctypes.c_int]
        _lib = lib
    except Exception:
        _build_failed = True
    return _lib


def have_native() -> bool:
    return _get_lib() is not None


# ---------------------------------------------------------------------------
# wrappers with fallbacks
# ---------------------------------------------------------------------------

def pgm_decode(data: bytes):
    """P5 bytes -> (img (H, W) uint8)."""
    lib = _get_lib()
    if lib is not None:
        buf = np.frombuffer(data, np.uint8)
        out = np.empty(len(data), np.uint8)
        w = ctypes.c_int()
        h = ctypes.c_int()
        n = lib.pgm_decode(buf, len(buf), out, len(out),
                           ctypes.byref(w), ctypes.byref(h))
        if n < 0:
            raise ValueError("invalid PGM")
        return out[:n].reshape(h.value, w.value).copy()
    # fallback
    import io

    f = io.BytesIO(data)
    assert f.readline().strip() == b"P5"
    line = f.readline()
    while line.startswith(b"#"):
        line = f.readline()
    w_, h_ = map(int, line.split())
    f.readline()
    return np.frombuffer(f.read(w_ * h_), np.uint8).reshape(h_, w_).copy()


def pgm_encode(img: np.ndarray) -> bytes:
    lib = _get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    if lib is not None:
        out = np.empty(img.size + 64, np.uint8)
        n = lib.pgm_encode(img.reshape(-1), img.shape[1], img.shape[0], out,
                           len(out))
        return out[:n].tobytes()
    return (b"P5\n" + f"{img.shape[1]} {img.shape[0]}\n255\n".encode()
            + img.tobytes())


def velodyne_unpack(raw: bytes):
    """NCLT velodyne bytes -> (xyz (N, 3) f32, intensity (N,) f32)."""
    lib = _get_lib()
    n = len(raw) // 8
    if lib is not None:
        buf = np.frombuffer(raw, np.uint8)
        xyz = np.empty((n, 3), np.float32)
        inten = np.empty(n, np.float32)
        lib.velodyne_unpack(buf, len(buf), xyz.reshape(-1), inten)
        return xyz, inten
    rec = np.frombuffer(raw, np.uint8)[: n * 8].reshape(n, 8)
    xyz = rec[:, :6].copy().view("<u2").reshape(n, 3).astype(np.float32)
    return xyz * 0.005 - 100.0, rec[:, 6].astype(np.float32)


def bresenham_update(grid: np.ndarray, r0: int, c0: int, r1s, c1s,
                     l_free=-0.4, l_occ=1.4, l_min=-5.0, l_max=5.0):
    """Reference-exact per-ray Bresenham log-odds update, in place."""
    grid = np.ascontiguousarray(grid, np.float32)
    r1s = np.ascontiguousarray(r1s, np.int32)
    c1s = np.ascontiguousarray(c1s, np.int32)
    lib = _get_lib()
    if lib is not None:
        lib.bresenham_update(grid, grid.shape[0], grid.shape[1],
                             int(r0), int(c0), r1s, c1s, len(r1s),
                             l_free, l_occ, l_min, l_max)
        return grid
    rows, cols = grid.shape
    for r1, c1 in zip(r1s, c1s):
        if not (0 <= r1 < rows and 0 <= c1 < cols):
            continue
        dr, dc = abs(r1 - r0), abs(c1 - c0)
        sr = 1 if r0 < r1 else -1
        sc = 1 if c0 < c1 else -1
        err = dr - dc
        r, c = r0, c0
        while True:
            if not (0 <= r < rows and 0 <= c < cols):
                break
            if (r, c) == (r1, c1):
                grid[r, c] = min(l_max, grid[r, c] + l_occ)
                break
            grid[r, c] = max(l_min, grid[r, c] + l_free)
            e2 = 2 * err
            if e2 > -dc:
                err -= dc
                r += sr
            if e2 < dr:
                err += dr
                c += sc
    return grid


def csv_parse_floats(text: bytes, n_cols: int, max_rows: int = 1_000_000):
    """Fast numeric-CSV parse -> (rows, n_cols) f64 (header lines skipped)."""
    lib = _get_lib()
    if lib is not None:
        out = np.empty((max_rows, n_cols), np.float64)
        n = lib.csv_parse_floats(text, len(text), out.reshape(-1), max_rows,
                                 n_cols)
        return out[:n].copy()
    rows = []
    for line in text.decode().splitlines():
        line = line.strip()
        if not line or not (line[0].isdigit() or line[0] in "-+."):
            continue
        parts = line.split(",")[:n_cols]
        if len(parts) == n_cols:
            try:
                rows.append([float(p) for p in parts])
            except ValueError:
                continue
    return np.asarray(rows, np.float64)
