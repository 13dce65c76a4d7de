"""Build the CUDA sources with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/<digest>/lib<name>.so``, where the
digest hashes every source under ``csrc/`` and the compiler flags, so an
edited source rebuilds and a stale library is never loaded. Sources compile
in parallel, one ``nvcc`` per file. The libraries have a plain C interface
(no PyTorch headers), which keeps a build to seconds.

Every C entry returns a ``cudaError_t``; :func:`check` raises on a nonzero
code, so a refused launch (too many threads, too much shared memory) is an
error at the call and never a silent no-op.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD / _digest() / f"lib{name}.so"


def build(*names: str) -> dict[str, str]:
    """Compile the named sources that are not built yet, all at once.

    Returns ``{name: nvcc output}`` for the sources compiled by this call
    (ptxas reports each kernel's registers, shared memory and spills).
    """
    todo = [n for n in names if not lib_path(n).is_file()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = lib_path(name)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"lib{name}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed
    (callers cache it with its ``argtypes`` set)."""
    build(name)
    return ctypes.CDLL(str(lib_path(name)))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed with cudaError_t {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
