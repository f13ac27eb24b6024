"""Native (C) runtime components: the parallel ``.npy`` shard reader.

The port's own copy of what :mod:`shadowing_tpu.native` does, used by
:class:`shadowing_tpu_torch.data.dataset.TimeSeriesDataset`. The C side
(``npyloader.c``, ``read_files_parallel``) reads whole files concurrently on
a pthread pool into buffers allocated here; it is called through ``ctypes``,
which releases the GIL for the call. The Python side sizes the files,
parses the npy headers with numpy's own format utilities and wraps the
buffers zero-copy.

The library is compiled from ``npyloader.c`` with the host C compiler
(``$CC``, else ``cc`` or ``gcc``) at first use, into
``build/native/<hash of source and flags>/`` beside the package, the way
:mod:`shadowing_tpu_torch.ops._build` builds the CUDA kernels. Nothing is
compiled at import. There is no fallback: a failed build, a missing file or
a bad header raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "npyloader.c"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ["-O2", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_fn = None


def _compiler() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError("no C compiler found: set CC to the host compiler")
    return cc


def library_path() -> Path:
    """Where the library for the current source is (or will be) built."""
    h = hashlib.sha256(" ".join(CFLAGS).encode() + SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libnpyloader.so"


def build() -> Path:
    """Compile the reader unless a library of the same source exists;
    returns its path."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmpdir:
        tmp = Path(tmpdir) / path.name
        cmd = [_compiler(), *CFLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"could not run {cmd[0]!r}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, path)      # atomic: a concurrent build never sees half a file
    return path


def _reader():
    global _fn
    with _lock:
        if _fn is None:
            fn = ctypes.CDLL(str(build())).read_files_parallel
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                           ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_size_t),
                           ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                           ctypes.c_int]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def read_files_parallel(paths: Sequence[str],
                        n_threads: int = 8) -> list[np.ndarray]:
    """Whole-file contents of ``paths`` as uint8 arrays, in input order,
    read concurrently by ``n_threads`` threads. Raises ``OSError`` for a
    file that cannot be sized, opened or read to its end."""
    paths = [os.fspath(p) for p in paths]
    bufs = [np.empty(os.stat(p).st_size, dtype=np.uint8) for p in paths]
    n = len(paths)
    read = _reader()
    c_paths = (ctypes.c_char_p * n)(*(os.fsencode(p) for p in paths))
    c_bufs = (ctypes.c_void_p * n)(*(b.ctypes.data for b in bufs))
    c_sizes = (ctypes.c_size_t * n)(*(b.size for b in bufs))
    errors = (ctypes.c_int * n)()
    failed = read(c_paths, c_bufs, c_sizes, errors, n, int(n_threads))
    if failed < 0:
        raise OSError("the shard reader could not start a thread")
    for p, err in zip(paths, errors):
        if err:
            raise OSError(err, os.strerror(err), p)
    return bufs


def _read_header(fobj):
    """(shape, fortran, dtype) of an open .npy stream via numpy's public
    format API (``read_array_header_1_0/2_0`` keyed on the magic version)."""
    version = np.lib.format.read_magic(fobj)
    if version == (1, 0):
        return np.lib.format.read_array_header_1_0(fobj)
    if version == (2, 0):
        return np.lib.format.read_array_header_2_0(fobj)
    raise ValueError(f"unsupported .npy format version {version}")


#: bytes of a file given to the header parser (a version-1 header is at
#: most 10 + 65,535 bytes; a longer one is refused as malformed)
_HEADER_MAX = 1 << 17


def _parse_npy(buf: np.ndarray) -> np.ndarray:
    """Zero-copy ndarray view over a raw .npy file buffer."""
    bio = io.BytesIO(buf[:_HEADER_MAX].tobytes())
    shape, fortran, dtype = _read_header(bio)
    arr = np.frombuffer(buf, dtype=dtype, offset=bio.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


def load_npy_batch(
    paths: Sequence[str], R: Optional[int] = None, n_threads: int = 8
) -> list[np.ndarray]:
    """Load .npy shards in parallel until ``R`` rows are available.

    Returns a list of arrays (one per shard read, in input order).
    """
    paths = list(paths)
    if R is not None:
        # size shards cheaply from headers to know how many files we need
        needed, rows = [], 0
        for p in paths:
            with open(p, "rb") as f:
                shape, _, _ = _read_header(f)
            needed.append(p)
            rows += shape[0]
            if rows >= R:
                break
        paths = needed
    return [_parse_npy(b) for b in read_files_parallel(paths, n_threads)]
