"""Build and load the CUDA kernels (`csrc/*.cu`).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with `ctypes`. The build runs at
first use, into ``build/`` beside this file (git-ignored); a library is
named by the hash of its source and flags, so an edited source rebuilds and
an unchanged one is reused. All missing libraries are compiled at once, one
``nvcc`` process per source, started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("rmsnorm", "flash_attention", "reshard_pack", "bucket", "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: Dict[str, ctypes.PyDLL] = {}
_fns: Dict[tuple, object] = {}
#: ptxas report (registers, shared memory, spills) of each library built
#: by this process.
ptxas_info: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels are built from "
        "source at first use and need the CUDA toolkit"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update((CSRC / "common.cuh").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, in
    parallel, and load them all. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in names if n not in _libs and not _lib_path(n).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failed = []
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            ptxas_info[n] = out
            if p.returncode != 0:
                failed.append(f"--- nvcc {n}.cu (rc {p.returncode}) ---\n{out}")
            else:
                os.replace(tmp, _lib_path(n))
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for n in names:
        if n not in _libs:
            _libs[n] = ctypes.PyDLL(str(_lib_path(n)))
    return time.perf_counter() - t0


def function(lib: str, symbol: str, argtypes: Sequence,
             restype=ctypes.c_int):
    """The C function ``symbol`` of library ``lib`` (building every library
    on first use), with its argument and return types declared."""
    key = (lib, symbol)
    if key not in _fns:
        if lib not in _libs:
            build_all()
        fn = getattr(_libs[lib], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[key] = fn
    return _fns[key]


def fail(err: int, lib: str) -> None:
    """Raise for the CUDA error code a launch of library ``lib`` returned."""
    msg = function(lib, "kernel_error_string", [ctypes.c_int],
                   restype=ctypes.c_char_p)
    raise RuntimeError(
        f"{lib}: CUDA launch failed: error {err} ({msg(err).decode()})"
    )


class Launcher:
    """The C launcher ``symbol`` of library ``lib``, resolved (every
    library built) at its first call. ``launcher(device, *args)`` calls
    ``symbol(*args, stream)`` on PyTorch's current stream of CUDA device
    ``device`` and raises on the error code it returns (its
    ``cudaGetLastError`` after the launch).

    On the decode paths the host's cost of this call is most of a small
    kernel's time, so it takes the raw stream handle without building a
    `torch.cuda.Stream` (as Triton's launcher does), makes ``device``
    current only when it is not already, and the libraries are loaded with
    `ctypes.PyDLL`, whose calls keep the GIL instead of releasing and
    retaking it around a launch that takes microseconds."""

    __slots__ = ("lib", "symbol", "argtypes", "fn")

    def __init__(self, lib: str, symbol: str, argtypes: Sequence):
        self.lib, self.symbol, self.argtypes = lib, symbol, argtypes
        self.fn = None

    def __call__(self, device: int, *args) -> None:
        fn = self.fn
        if fn is None:
            fn = self.fn = function(self.lib, self.symbol, self.argtypes)
        if torch._C._cuda_getDevice() == device:
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
        else:
            with torch.cuda.device(device):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
        if err:
            fail(err, self.lib)
