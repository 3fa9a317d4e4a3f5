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
``launch`` calls a library's C entry on the current CUDA stream and raises
on a launch error; ``check_operand`` and ``cuda_device`` are the launchers'
operand checks.
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

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")
# every library, one per csrc/<name>.cu: the ELL kernel (strided, packed
# and dense launches), the fused ELL→GEMM kernel, the Mamba-2 SSD scan in
# f32 (FFMA) and in bf16 (tensor cores, three passes), flash attention in
# f32 (FFMA) and in bf16 (tensor cores), the trainer's per-lane FISTA prox
LIBRARIES = ("community_spmm_ell", "community_spmm_ell_fused", "ssd_scan",
             "ssd_scan_wgmma", "flash_attention", "flash_attention_wgmma",
             "fista_lanes")

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


def launch(kernel: str, lib_name: str, symbol: str, tensors: list,
           scalars: list, device: torch.device, error_symbol: str) -> None:
    """Call ``symbol(pointers..., scalars..., stream)`` of library
    ``lib_name`` on ``device``'s current stream: a pointer per tensor (a
    null one per None), a C ``int`` per Python int and a C ``float`` per
    Python float.  The C function returns its launch's ``cudaError_t``; a
    non-zero one raises, with the library's ``error_symbol(code)`` text."""
    lib = load(lib_name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:     # first use: declare the C signature
        fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                       + [ctypes.c_float if isinstance(x, float)
                          else ctypes.c_int for x in scalars]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = getattr(lib, error_symbol)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*[None if t is None else t.data_ptr() for t in tensors],
                  *scalars, stream)
    if code != 0:
        msg = getattr(lib, error_symbol)(code).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} "
                           f"(cudaError {code})")


def check_operand(name: str, t: torch.Tensor, shape: tuple, dtypes: tuple,
                  device: torch.device) -> None:
    """Raise unless ``t`` lies on ``device``, has one of ``dtypes``, has
    ``shape`` and is contiguous: what a kernel's raw pointer assumes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cuda_device(kernel: str, z: torch.Tensor) -> torch.device:
    """``z``'s device, or ValueError unless it is a CUDA device."""
    if z.device.type != "cuda":
        raise ValueError(f"the CUDA kernel {kernel} needs CUDA tensors, got "
                         f"{z.device}")
    return z.device
