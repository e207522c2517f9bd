"""The host SAH builder in C++, compiled on demand and bound with ctypes — a
copy of the SAH part of ``tpurt/native/build.py``.

``csrc/host/sah_build.cpp`` is compiled with ``g++`` into
``tpurt_torch/_build/`` (ignored by git) at first use, named by a hash of
the source, the flags and the host CPU's feature flags (``-march=native``
code runs only where it was built). Every failure (no ``g++``, a failed
build or load) makes :func:`get_lib` return None, and the caller then
builds the same tree with numpy, exactly as tpurt does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SRC = PKG_DIR / "csrc" / "host" / "sah_build.cpp"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _cpu_tag() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def library_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_tag().encode())
    return BUILD_DIR / f"tpurt_torch_host_{h.hexdigest()[:12]}.so"


def get_lib():
    """The loaded host library, built if needed; None when it cannot be
    built or loaded (the caller falls back to numpy)."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = library_path()
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except Exception:  # noqa: BLE001 — any failure means numpy
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.tpurt_build_sah.argtypes = [
            f32p, f32p, ctypes.c_int32, ctypes.c_int32,
            f32p, f32p, i32p, i32p, i32p, i32p, i32p]
        lib.tpurt_build_sah.restype = ctypes.c_int32
        _LIB = lib
        return _LIB


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_build_sah(aabb_min, aabb_max, max_leaf: int):
    """FlatBVH fields as a dict, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    amin = np.ascontiguousarray(aabb_min, np.float32).reshape(-1, 3)
    amax = np.ascontiguousarray(aabb_max, np.float32).reshape(-1, 3)
    n = len(amin)
    if n == 0:
        return None
    cap = max(2 * n, 2)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    entry = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    order = np.empty(n, np.int32)
    m = lib.tpurt_build_sah(
        _ptr(amin, ctypes.c_float), _ptr(amax, ctypes.c_float), n, max_leaf,
        _ptr(node_min, ctypes.c_float), _ptr(node_max, ctypes.c_float),
        _ptr(entry, ctypes.c_int32), _ptr(skip, ctypes.c_int32),
        _ptr(first, ctypes.c_int32), _ptr(count, ctypes.c_int32),
        _ptr(order, ctypes.c_int32))
    if m <= 0:
        return None
    return dict(
        aabb_min=node_min[:m].copy(), aabb_max=node_max[:m].copy(),
        entry=entry[:m].copy(), skip=skip[:m].copy(),
        first_tri=first[:m].copy(), tri_count=count[:m].copy(),
        tri_order=order,
    )
