"""Build and bind the hand-written CUDA kernels of ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, placed under
``build/torch_kernels/<hash of sources and flags>/`` beside the package, and
loaded with ``ctypes``. Each C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; :meth:`Kernel.launch` raises if
that is not 0. Nothing here is imported or compiled at module import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from shadowing_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libshadowing_kernels.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library of the same sources exists;
    returns its path. ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report of registers and shared memory."""
    path = library_path()
    if path.exists() and not verbose:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=path.parent) as tmpdir:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmpdir) / f"{src.stem}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                 "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        logs = [(p, *p.communicate()) for p in procs]
        for p, _, err in logs:
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{err[-4000:]}")
        if verbose:   # ptxas's C7519 notes (one per register-A wgmma site) left out
            lines = [ln for _, _, err in logs for ln in err.strip().splitlines()]
            print("\n".join(ln for ln in lines if "(C7519)" not in ln))
        tmp = Path(tmpdir) / path.name
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, path)      # atomic: concurrent builders never see half a file
    return path


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


class Kernel:
    """One C entry point of the library, with its launch counter.

    ``argtypes`` lists the ctypes of the arguments before the trailing
    stream (pointers as ``c_void_p``, sizes as ``c_int``)."""

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.argtypes = argtypes
        self._fn = None

    @property
    def launches(self) -> int:
        """Successful launches: the counter ``launch.<name>`` of
        :mod:`shadowing_tpu_torch.utils.profiling`; assigning sets it."""
        return profiling.counters().get(f"launch.{self.name}", 0)

    @launches.setter
    def launches(self, n: int) -> None:
        profiling.count(f"launch.{self.name}", n - self.launches)

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_library(), self.name)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error "
                               f"{err} ({_error_name(err)})")
        profiling.count(f"launch.{self.name}")


def _error_name(err: int) -> str:
    fn = _library().kernels_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_tensor(t: torch.Tensor, name: str, ndim: int, device,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank ``ndim``
    on ``device`` — what the kernels' raw pointers assume."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        kind = str(dtype).removeprefix("torch.")
        raise ValueError(f"{name} must be a contiguous {kind} {ndim}-d tensor, "
                         f"got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
