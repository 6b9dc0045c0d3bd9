"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface under ``hap_tpu_torch/_build/`` at first use, all sources
in parallel, and loaded with ctypes. A library is rebuilt when its source
or a header in ``csrc/`` is newer. Every C entry point launches on the
stream it is given and returns ``cudaGetLastError()``;
``CudaKernel.__call__`` raises on a nonzero code and counts the launch.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home}/bin)")
    return path


def _lib_path(source: str) -> Path:
    return BUILD / (Path(source).stem + ".so")


def _stale(source: str) -> bool:
    lib = _lib_path(source)
    newest = max(p.stat().st_mtime
                 for p in [CSRC / source, *CSRC.glob("*.cuh")])
    return not lib.exists() or lib.stat().st_mtime < newest


def build_all(sources=None) -> dict:
    """Compile every stale source (default: all of ``csrc/*.cu``), one
    nvcc process per source, all started together. Returns {source: ptxas
    report} for the sources it compiled; raises with nvcc's output if one
    fails."""
    if sources is None:
        sources = sorted(p.name for p in CSRC.glob("*.cu"))
    todo = [s for s in sources if _stale(s)]
    if not todo:
        return {}
    BUILD.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = {
        s: subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(_lib_path(s)), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s in todo
    }
    reports, failed = {}, []
    for s, p in procs.items():
        out, _ = p.communicate()
        reports[s] = out
        if p.returncode != 0:
            failed.append(f"--- {s} (exit {p.returncode})\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building every stale source
    first."""
    lib = _libs.get(source)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(source)))
        _libs[source] = lib
    return lib


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` -- what a kernel's raw pointer arguments assume."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous on {device}")


def current_stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


class CudaKernel:
    """One C entry point of a ``csrc`` source plus its launch count.

    ``argtypes`` are ctypes types; pointers and the stream are passed as
    ``ctypes.c_void_p`` (Python ints from ``data_ptr()`` and
    ``cuda_stream``). ``launches`` counts the launches this process made
    through ``__call__`` and nothing else."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self.launches = 0
        self._fn = None

    def __call__(self, *args, stream) -> None:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with error {rc}")
        self.launches += 1
