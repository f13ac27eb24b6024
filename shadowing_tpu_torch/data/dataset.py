"""Sharded on-disk trajectory datasets.

Port of :mod:`shadowing_tpu.data.dataset`: a directory of ``.npy`` shards
(each ``(r_i, C, T)`` or ``(r_i, T)``), loaded lazily, keeping the first
``R`` trajectories. Shards are read concurrently by the parallel reader of
:mod:`shadowing_tpu_torch.native`, built at first use; a reader that cannot
be built, a missing file or a bad header raises (there is no second read
through ``numpy.load``). Device placement is the engine's job.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def _shard_files(dpath: Path) -> list[Path]:
    files = sorted(p for p in Path(dpath).iterdir() if p.suffix == ".npy")
    if not files:
        raise FileNotFoundError(f"no .npy shards under {dpath}")
    return files


class TimeSeriesDataset:
    """Lazy loader over a directory of ``.npy`` trajectory shards.

    :param dpath: directory containing ``.npy`` shards
    :param R: number of trajectories to keep (``None`` = all)
    """

    def __init__(self, dpath: Path | str, R: Optional[int] = None):
        self.dpath = Path(dpath)
        self.R = R
        self._files = _shard_files(self.dpath)

    def load(self) -> np.ndarray:
        """Materialise the first ``R`` trajectories as a ``(R, C, T)`` array."""
        from shadowing_tpu_torch.native import load_npy_batch

        out = np.concatenate(
            load_npy_batch([str(f) for f in self._files], self.R), axis=0)
        if self.R is not None:
            if out.shape[0] < self.R:
                raise ValueError(
                    f"dataset under {self.dpath} holds {out.shape[0]} "
                    f"trajectories, fewer than requested R={self.R}"
                )
            out = out[: self.R]
        if out.ndim == 2:
            out = out[:, None, :]
        if out.ndim != 3:
            raise ValueError(f"shards must be (r, C, T) or (r, T), got {out.shape}")
        return np.ascontiguousarray(out, dtype=np.float32)


def batch_npy_files(
    input_directory: Path | str,
    batch_size: int,
    output_directory: Path | str,
) -> list[Path]:
    """Regroup many small per-trajectory ``.npy`` files into shards named
    ``batch0001.npy`` …, ``batch_size`` source files each (remainder kept)."""
    output_directory = Path(output_directory)
    output_directory.mkdir(parents=True, exist_ok=True)
    files = _shard_files(Path(input_directory))
    written = []
    for i in range(0, len(files), batch_size):
        chunk = [np.load(f) for f in files[i : i + batch_size]]
        out = output_directory / f"batch{i // batch_size + 1:04d}.npy"
        np.save(out, np.concatenate(chunk))
        written.append(out)
    return written
