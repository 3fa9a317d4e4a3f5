"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface (raw device
pointers, shapes and a ``cudaStream_t``), so it compiles with ``nvcc`` alone
in seconds — no PyTorch headers and no ``ninja``.  The shared library lands
in ``build/torch_ext/<hash>/`` at the repository root, where the hash covers
the source bytes, the shared headers (``csrc/*.cuh``) and the nvcc flags: an
edited source, header or flag builds anew, an unchanged one is reused.  Two
processes building the same library at once are safe: each compiles to its
own temporary file and moves it into place with an atomic ``os.replace``.
Within a process, different libraries build concurrently (``load_all``).

Nothing here runs at import time; the first kernel launch calls ``load``.
A missing ``nvcc`` or a failed compile raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")
# every library, one per csrc/<name>.cu: the ELL and packed kernels, the
# fused ELL→GEMM kernel, the dense block-row kernel
LIBRARIES = ("community_spmm_ell", "community_spmm_ell_fused",
             "community_spmm_dense")

_loaded: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}
_lock = threading.Lock()      # guards ``_locks``


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built from source at first use")


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by source bytes, the shared
    headers' bytes and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers
                         + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / key[:16] / f"lib{name}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        name_lock = _locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib


def load_all(names) -> list[ctypes.CDLL]:
    """``load`` every library in ``names`` at once: one nvcc per source, all
    started together; raises the first build failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return list(pool.map(load, names))
