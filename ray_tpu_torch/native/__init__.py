"""Native (C++) components, loaded via ctypes.

Parity: the reference's C++ core (SURVEY.md §2.1). ``object_store.cc`` is
built at first use, with ``make`` and this directory's Makefile, into
``build/ray_tpu_torch_native/`` at the repository root (git-ignored). The
library's name carries a hash of the sources and the Makefile, so an edited
source is rebuilt and a stale library is never loaded. The store keeps a
pure-Python fallback for hosts without a toolchain (``native_store.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_LIB = None
_LIB_TRIED = False

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "ray_tpu_torch_native")
_SOURCES = ("object_store.cc", "rt_store.h", "Makefile")


def library_path() -> str:
    digest = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_DIR, name), "rb") as fh:
            digest.update(name.encode() + b"\0" + fh.read() + b"\0")
    return os.path.join(BUILD_DIR, f"libray_tpu_torch_native-{digest.hexdigest()[:16]}.so")


def _try_build(so: str) -> bool:
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["make", "-s", f"TARGET={so}"], cwd=_DIR, check=True, capture_output=True, timeout=120
        )
        return os.path.exists(so)
    except Exception:
        return False


def load_native():
    """Returns the loaded CDLL or None (builds on first use if needed)."""
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    so = library_path()
    if not os.path.exists(so) and not _try_build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.rt_store_open.restype = ctypes.c_void_p
    lib.rt_store_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.c_int,
    ]
    lib.rt_store_close.argtypes = [ctypes.c_void_p]
    lib.rt_store_create.restype = ctypes.c_uint64
    lib.rt_store_create.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.rt_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_store_get.restype = ctypes.c_uint64
    lib.rt_store_get.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.rt_store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_store_abort.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_store_used_bytes.restype = ctypes.c_uint64
    lib.rt_store_used_bytes.argtypes = [ctypes.c_void_p]
    lib.rt_store_num_objects.restype = ctypes.c_uint64
    lib.rt_store_num_objects.argtypes = [ctypes.c_void_p]
    lib.rt_store_base.restype = ctypes.c_void_p
    lib.rt_store_base.argtypes = [ctypes.c_void_p]
    lib.rt_store_capacity.restype = ctypes.c_uint64
    lib.rt_store_capacity.argtypes = [ctypes.c_void_p]
    lib.rt_store_lru_victim.restype = ctypes.c_int
    lib.rt_store_lru_victim.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    if hasattr(lib, "rt_store_prefault"):
        lib.rt_store_prefault.restype = ctypes.c_uint64
        lib.rt_store_prefault.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    _LIB = lib
    return _LIB
