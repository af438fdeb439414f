"""Native (C++) host component: fast OBJ parsing.

The reference implements its host pipeline in C++17 (OBJ loader,
CLOBJloader.cpp). This framework keeps the heavy host-side parse in C++
too: ``native/objparse.cpp`` is compiled on demand with g++ into a shared
library loaded through ctypes (no pybind11 needed). The library is built
inside the checkout (``.cache/native``, git-ignored) and named by a hash
of its sources, so it always matches the committed code. Everything
degrades gracefully to the pure-Python parser when no compiler is
available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_NATIVE = os.path.join(_REPO, "native")
_SOURCES = ("objparse.cpp",)
_CACHE_DIR = os.path.join(_REPO, ".cache", "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _library_path(sources: List[str]) -> str:
    """Build-output path keyed on the sources' contents."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_CACHE_DIR, f"libmoclrt-{h.hexdigest()[:16]}.so")


def _build_library() -> Optional[str]:
    sources = [os.path.join(_REPO_NATIVE, f) for f in _SOURCES]
    if not all(os.path.exists(s) for s in sources):
        return None
    out = _library_path(sources)
    if os.path.exists(out):
        return out
    os.makedirs(_CACHE_DIR, exist_ok=True)
    # Build to a private name, then rename: concurrent builders (test
    # workers) never load a half-written library.
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", "-o", tmp] + sources
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    os.replace(tmp, out)
    return out


def get_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build_library()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _lib_failed = True
            return None
        lib.obj_count.restype = ctypes.c_int64
        lib.obj_count.argtypes = [ctypes.c_char_p]
        lib.obj_num_materials.restype = ctypes.c_int
        lib.obj_material_name.restype = ctypes.c_int
        lib.obj_material_name.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                          ctypes.c_int]
        lib.obj_fill.restype = ctypes.c_int
        lib.obj_fill.argtypes = [ctypes.POINTER(ctypes.c_float)] * 3 + [
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def available() -> bool:
    return get_library() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def parse_obj_native(path: str) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray,
                                                  List[str]]]:
    """Parse an OBJ with the C++ parser.

    Returns (v [3,T,3], n [3,T,3], uv [3,T,2], mat_idx [T], usemtl names)
    or None if the native library is unavailable / parse failed.
    """
    lib = get_library()
    if lib is None:
        return None
    T = lib.obj_count(path.encode())
    if T < 0:
        return None
    v = np.empty((3, T, 3), np.float32)
    n = np.empty((3, T, 3), np.float32)
    uv = np.empty((3, T, 2), np.float32)
    mat = np.empty((T,), np.int32)
    nm = lib.obj_num_materials()
    names = []
    buf = ctypes.create_string_buffer(512)
    for i in range(nm):
        lib.obj_material_name(i, buf, 512)
        names.append(buf.value.decode())
    if lib.obj_fill(_fptr(v), _fptr(n), _fptr(uv), _iptr(mat)) != 0:
        return None
    return v, n, uv, mat, names
