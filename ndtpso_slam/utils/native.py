"""ctypes bindings for the native C++ components.

Two shared libraries, built from ``native/*/*.cpp`` by ``make -C native``
into ``native/build/`` (not tracked by git).  The first use in a process
runs that make, which rebuilds whatever is older than its source:

* ``libgolden.so`` — the double-precision golden reference (map stats, cost,
  PSO, SLAM loop) with the engine's Threefry protocol, used by the parity
  suite and available as a CPU fallback solver.
* ``libndtruntime.so`` — IO runtime: binary scan-log reader/writer, CSV /
  gnuplot / PNG exporters (the `NDTFrame::dumpMap` capability,
  `ndtframe.cpp:268-422`, without OpenCV).
"""

from __future__ import annotations

import ctypes as ct
import fcntl
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def build() -> None:
    """``make -C native``: (re)build both libraries from source.  Holds an
    exclusive lock on the Makefile meanwhile, so processes starting
    together (test workers) never load a library another one is writing."""
    native_dir = os.path.abspath(_NATIVE_DIR)
    with open(os.path.join(native_dir, "Makefile")) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(
            ["make", "-C", native_dir], capture_output=True, text=True
        )
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed (rc={proc.returncode}):\n{proc.stdout}"
            f"{proc.stderr}"
        )


_built = False


def _load(name: str) -> ct.CDLL:
    global _built
    if not _built:
        build()
        _built = True
    return ct.CDLL(os.path.abspath(os.path.join(_NATIVE_DIR, "build", name)))


_golden: Optional[ct.CDLL] = None
_runtime: Optional[ct.CDLL] = None

_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


def golden() -> ct.CDLL:
    global _golden
    if _golden is None:
        lib = _load("libgolden.so")
        lib.golden_threefry.argtypes = [
            ct.c_uint32, ct.c_uint32, _U32, _U32, ct.c_long, _U32, _U32,
        ]
        lib.golden_map_new.restype = ct.c_void_p
        lib.golden_map_new.argtypes = [ct.c_double, ct.c_double, ct.c_int, ct.c_int]
        lib.golden_map_free.argtypes = [ct.c_void_p]
        lib.golden_map_update.argtypes = [ct.c_void_p, _F64, _F64, _U8, ct.c_long]
        lib.golden_map_build.argtypes = [ct.c_void_p]
        lib.golden_map_cell.argtypes = [ct.c_void_p, ct.c_long, _F64]
        lib.golden_map_cell.restype = ct.c_int
        lib.golden_cost.restype = ct.c_double
        lib.golden_cost.argtypes = [ct.c_void_p, _F64, _F64, _U8, ct.c_long]
        lib.golden_pso.argtypes = [
            ct.c_void_p, _F64, _U8, ct.c_long, _F64, _F64, ct.c_int, ct.c_int,
            ct.c_double, ct.c_double, ct.c_double, ct.c_double,
            ct.c_uint32, ct.c_uint32, _F64, _F64,
        ]
        lib.golden_slam_run.argtypes = [
            ct.c_double, ct.c_double, ct.c_int, ct.c_int, _F64, _U8,
            ct.c_long, ct.c_long, _F64, ct.c_int, ct.c_int,
            ct.c_double, ct.c_double, ct.c_double, ct.c_double,
            ct.c_uint32, ct.c_uint32, _F64,
        ]
        _golden = lib
    return _golden


def runtime() -> ct.CDLL:
    global _runtime
    if _runtime is None:
        lib = _load("libndtruntime.so")
        lib.runtime_write_pose_csv.argtypes = [ct.c_char_p, _F64, _F64, _F64, ct.c_long]
        lib.runtime_write_map_csv.argtypes = [ct.c_char_p, _F64, ct.c_long]
        lib.runtime_write_gnuplot.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int, ct.c_int]
        lib.runtime_write_png_gray.argtypes = [ct.c_char_p, _U8, ct.c_long, ct.c_long]
        lib.runtime_write_png_rgb.argtypes = [ct.c_char_p, _U8, ct.c_long, ct.c_long]
        lib.runtime_scanlog_write.argtypes = [
            ct.c_char_p, _F32, _F64, _F64, _F64, ct.c_int64, ct.c_int64,
            ct.c_double, ct.c_double, ct.c_double,
        ]
        lib.runtime_scanlog_read.argtypes = [
            ct.c_char_p, ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_double), ct.POINTER(ct.c_double),
            ct.POINTER(ct.c_double),
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ]
        _runtime = lib
    return _runtime


# --------------------------------------------------------------- golden API
class GoldenMap:
    """Double-precision reference NDT map (sparse hash grid, raw points)."""

    def __init__(self, size_m: float, cell_side: float, slots: int = 100,
                 capacity: int = 50):
        self._lib = golden()
        self._h = self._lib.golden_map_new(size_m, cell_side, slots, capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.golden_map_free(self._h)
            self._h = None

    def update(self, pose, points, valid=None):
        points = np.ascontiguousarray(points, np.float64)
        n = len(points)
        valid = _valid_arr(valid, n)
        self._lib.golden_map_update(
            self._h, np.ascontiguousarray(pose, np.float64), points, valid, n
        )

    def build(self):
        self._lib.golden_map_build(self._h)

    def cell(self, index: int):
        out = np.zeros(5)
        ok = self._lib.golden_map_cell(self._h, index, out)
        return (out[:2].copy(), out[2:].copy()) if ok else None

    def cost(self, pose, points, valid=None) -> float:
        points = np.ascontiguousarray(points, np.float64)
        n = len(points)
        return self._lib.golden_cost(
            self._h, np.ascontiguousarray(pose, np.float64), points,
            _valid_arr(valid, n), n,
        )

    def pso(self, points, guess, deviation, key: Tuple[int, int],
            iterations=50, population=30, w=0.8, c1=2.0, c2=2.0,
            w_damping=1.0, valid=None):
        points = np.ascontiguousarray(points, np.float64)
        n = len(points)
        pose = np.zeros(3)
        cost = np.zeros(1)
        self._lib.golden_pso(
            self._h, points, _valid_arr(valid, n), n,
            np.ascontiguousarray(guess, np.float64),
            np.ascontiguousarray(deviation, np.float64),
            iterations, population, w, c1, c2, w_damping,
            int(key[0]), int(key[1]), pose, cost,
        )
        return pose, float(cost[0])


def _valid_arr(valid, n):
    if valid is None:
        return np.ones(n, np.uint8)
    return np.ascontiguousarray(np.asarray(valid).astype(np.uint8))


def golden_threefry(key, c0, c1):
    c0 = np.ascontiguousarray(c0, np.uint32)
    c1 = np.ascontiguousarray(c1, np.uint32)
    o0 = np.zeros_like(c0)
    o1 = np.zeros_like(c1)
    golden().golden_threefry(int(key[0]), int(key[1]), c0, c1, len(c0), o0, o1)
    return o0, o1


def golden_slam_run(points, valid, init_pose, size_m, cell_side, slots,
                    capacity, key, iterations, population, w=0.8, c1=2.0,
                    c2=2.0, w_damping=1.0):
    """Run the golden SLAM loop over a [T, N, 2] point log."""
    points = np.ascontiguousarray(points, np.float64)
    t, n = points.shape[:2]
    valid = np.ascontiguousarray(np.asarray(valid).astype(np.uint8))
    out = np.zeros((t, 3))
    golden().golden_slam_run(
        size_m, cell_side, slots, capacity, points.reshape(-1), valid.reshape(-1),
        t, n, np.ascontiguousarray(init_pose, np.float64),
        iterations, population, w, c1, c2, w_damping,
        int(key[0]), int(key[1]), out.reshape(-1),
    )
    return out


# -------------------------------------------------------------- runtime API
def write_pose_csv(path: str, timestamps, poses, odoms=None):
    poses = np.ascontiguousarray(poses, np.float64)
    n = len(poses)
    ts = np.ascontiguousarray(timestamps, np.float64)
    od = np.ascontiguousarray(
        odoms if odoms is not None else np.zeros((n, 3)), np.float64
    )
    runtime().runtime_write_pose_csv(path.encode(), ts, poses, od, n)


def write_map_csv(path: str, points):
    points = np.ascontiguousarray(points, np.float64)
    runtime().runtime_write_map_csv(path.encode(), points, len(points))


def write_gnuplot(path: str, basename: str, save_points=True, save_poses=True):
    runtime().runtime_write_gnuplot(
        path.encode(), basename.encode(), int(save_points), int(save_poses)
    )


def write_png(path: str, pixels: np.ndarray):
    """pixels: [H, W] grayscale or [H, W, 3] RGB uint8."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    if pixels.ndim == 2:
        runtime().runtime_write_png_gray(path.encode(), pixels, w, h)
    else:
        runtime().runtime_write_png_rgb(path.encode(), pixels.reshape(-1), w, h)


def scanlog_write(path, ranges, poses, odoms, timestamps, angle_min,
                  angle_increment, range_max):
    ranges = np.ascontiguousarray(ranges, np.float32)
    t, b = ranges.shape
    runtime().runtime_scanlog_write(
        path.encode(), ranges, np.ascontiguousarray(poses, np.float64),
        np.ascontiguousarray(odoms, np.float64),
        np.ascontiguousarray(timestamps, np.float64), t, b,
        float(angle_min), float(angle_increment), float(range_max),
    )


def scanlog_read(path):
    lib = runtime()
    t = ct.c_int64()
    b = ct.c_int64()
    amin = ct.c_double()
    ainc = ct.c_double()
    rmax = ct.c_double()
    rc = lib.runtime_scanlog_read(
        path.encode(), ct.byref(t), ct.byref(b), ct.byref(amin),
        ct.byref(ainc), ct.byref(rmax), None, None, None, None,
    )
    if rc != 0:
        raise IOError(f"scanlog_read({path}) header failed rc={rc}")
    ranges = np.zeros((t.value, b.value), np.float32)
    poses = np.zeros((t.value, 3))
    odoms = np.zeros((t.value, 3))
    ts = np.zeros(t.value)
    rc = lib.runtime_scanlog_read(
        path.encode(), ct.byref(t), ct.byref(b), ct.byref(amin),
        ct.byref(ainc), ct.byref(rmax),
        ranges.ctypes.data_as(ct.c_void_p), poses.ctypes.data_as(ct.c_void_p),
        odoms.ctypes.data_as(ct.c_void_p), ts.ctypes.data_as(ct.c_void_p),
    )
    if rc != 0:
        raise IOError(f"scanlog_read({path}) payload failed rc={rc}")
    from ndtpso_slam.io.synthetic import ScanLog

    return ScanLog(
        ranges=ranges, poses=poses, odoms=odoms, timestamps=ts,
        angle_min=amin.value, angle_increment=ainc.value, range_max=rmax.value,
    )
