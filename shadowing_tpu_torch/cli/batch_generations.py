"""Regroup per-task generation files into large shards for fast loading.

Port of :mod:`shadowing_tpu.cli.batch_generations` on
:func:`shadowing_tpu_torch.data.dataset.batch_npy_files` (``batch%04d.npy``
naming, 256 source files per shard by default)::

    python -m shadowing_tpu_torch.cli.batch_generations --input DIR --output DIR
"""
from __future__ import annotations

import argparse
from pathlib import Path

from shadowing_tpu_torch.data.dataset import batch_npy_files


def main(argv=None):
    root = Path(__file__).parents[2] / "_cache"
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input", type=Path,
                        default=root / "snp_generation_torch")
    parser.add_argument("--output", type=Path,
                        default=root / "snp_generation_torch_batched")
    parser.add_argument("--batch-size", type=int, default=256)
    args = parser.parse_args(argv)

    written = batch_npy_files(args.input, args.batch_size, args.output)
    print(f"wrote {len(written)} shards under {args.output}")
    print("FINISHED")


if __name__ == "__main__":
    main()
