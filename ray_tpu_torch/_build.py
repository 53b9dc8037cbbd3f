"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/ray_tpu_torch/`` at
the repository root (git-ignored). The library's file name carries a hash
of its source, of the shared headers (``csrc/*.cuh``) and of nvcc's flags,
so an edited source, header or flag is rebuilt and a stale library is never
loaded. ``build_all`` starts one ``nvcc`` per source at once.

Every C entry point takes its pointers and the CUDA stream as ``void*``
and its sizes as ``int``, launches on the given stream, and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ray_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
)

# C signatures: name -> (library, argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, tuple] = {
    # q, k, v, out, lse, B, Sq, Sk, H, KV, D, causal, scale, stream
    "flash_attention_fwd": (
        "flash_attention",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    # q, k, v, out, lse, d_out, delta, dq, dk, dv, B, Sq, Sk, H, KV, D,
    # causal, scale, stream
    "flash_attention_bwd": (
        "flash_attention_bwd",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    # q, k_pool, v_pool, block_tables, positions, out, partial_o, partial_ml,
    # counters, B, H, KV, D, max_blocks, block_size, num_blocks, n_splits,
    # scale, stream
    "paged_attention_decode": (
        "paged_attention",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    # torch's lookup: $CUDA_HOME, then nvcc on PATH, then the default install
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(nvcc)


def library_path(name: str, csrc: Path = CSRC, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Where ``csrc/<name>.cu``'s library lives. Its name carries a hash of
    what the library is built from: the source, every shared header
    (``csrc/*.cuh``, which any source may include) and nvcc's flags."""
    digest = hashlib.sha256()
    for path in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update("\0".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    ``(popen, tmp, out)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(
    names: Sequence[str] = ("flash_attention", "flash_attention_bwd", "paged_attention"),
) -> Dict[str, str]:
    """Compile every named source that is not built yet, all at once; returns
    nvcc's output per source."""
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, s) for n, s in started.items()}


def _load(lib_name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(lib_name)
        if lib is None:
            _finish(lib_name, _start(lib_name))
            lib = ctypes.CDLL(str(library_path(lib_name)))
            for fn_name, (owner, argtypes) in SIGNATURES.items():
                if owner == lib_name:
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[lib_name] = lib
        return lib


def function(fn_name: str):
    """The bound C entry point ``fn_name``, building its library if needed."""
    return getattr(_load(SIGNATURES[fn_name][0]), fn_name)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
