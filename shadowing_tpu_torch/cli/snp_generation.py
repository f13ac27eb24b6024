"""Generate scattering-spectra realizations calibrated to the bundled
S&P daily series.

Port of :mod:`shadowing_tpu.cli.snp_generation`, with the same flags and
semantics: task ``tid`` of ``ntot`` generates ``R // ntot`` trajectories
into a shared cache directory, independently restartable (an existing task
file is skipped; an interrupted task resumes from its finished shards);
``batch_generations`` then regroups the task files for fast loading.
``-ntot``/``-tid`` default to the world size and the rank of a ``torchrun``
launch (one task without one); ``--device`` picks the card (default
``cuda``: each rank takes ``cuda:{LOCAL_RANK % device_count()}``) or ``cpu``.

Example (single task):
    python -m shadowing_tpu_torch.cli.snp_generation -R 1024 -J 9 --epsilon 1e-2
Job array (4 tasks):
    python -m shadowing_tpu_torch.cli.snp_generation -ntot 4 -tid $TASK_ID
The same 4 tasks as one launch, one rank each:
    torchrun --nproc-per-node 4 -m shadowing_tpu_torch.cli.snp_generation
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-ntot", type=int, default=None,
                        help="total number of job-array tasks (default: the "
                        "world size, 1 without torchrun)")
    parser.add_argument("-tid", type=int, default=None,
                        help="this task's id (default: the rank)")
    parser.add_argument("-J", type=int, default=9, help="number of scales")
    parser.add_argument("-R", type=int, default=32768,
                        help="total number of realizations (over all tasks)")
    parser.add_argument("--epsilon", type=float, default=1e-2,
                        help="per-seed RMS statistic mismatch tolerance")
    parser.add_argument("--max-iterations", type=int, default=1000)
    parser.add_argument("-T", type=int, default=None,
                        help="trajectory length (default: pow2 >= observed)")
    parser.add_argument("--batch", type=int, default=256,
                        help="seeds optimised together per device batch")
    parser.add_argument("--start", default="03-01-2000")
    parser.add_argument("--end", default="31-12-2014")
    parser.add_argument("--data", type=Path, default=None,
                        help="calibration series as an snp_daily-schema .npz "
                        "(produce one from a real date,close CSV with "
                        "shadowing_tpu_torch.cli.ingest_prices); default: the "
                        "bundled synthetic stand-in")
    parser.add_argument("--cache", type=Path,
                        default=Path(__file__).parents[2] / "_cache"
                        / "snp_generation_torch")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--init", choices=("auto", "coloured", "white"),
                        default="auto",
                        help="seed initialisation: 'auto' (spectrum-coloured"
                        " + per-seed-calibrated volatility envelope),"
                        " 'coloured' (spectrum only) or 'white'")
    parser.add_argument("--device", default="cuda",
                        help="where to synthesise: 'cuda' (default) or 'cpu'")
    parser.add_argument("-q", "--quiet", action="store_true")
    args = parser.parse_args(argv)
    if None not in (args.ntot, args.tid) and not 0 <= args.tid < args.ntot:
        parser.error(f"task id {args.tid} out of range for ntot={args.ntot}")
    return args


def main(argv=None):
    args = get_args(argv)
    from shadowing_tpu_torch.array_types import as_numpy
    from shadowing_tpu_torch.data.snp import SPDaily
    from shadowing_tpu_torch.models.scattering import generate
    from shadowing_tpu_torch.parallel import initialize, rank_device, task_split

    initialize(args.device)
    ntot, tid = task_split(args.ntot, args.tid)
    snp = SPDaily(start=args.start, end=args.end, path=args.data)
    r_task = args.R // ntot
    out_file = Path(args.cache) / f"task{tid:05d}_R{r_task}.npy"
    out_file.parent.mkdir(parents=True, exist_ok=True)
    if out_file.exists():
        print(f"{out_file} already exists — skipping (restart semantics)")
        print("FINISHED")
        return

    x_gen = generate(
        x=snp,
        gen_log_returns=True,
        R=r_task,
        J=args.J,
        T=args.T,
        tol_optim=args.epsilon,
        max_iterations=args.max_iterations,
        cache_path=Path(args.cache) / "_shards",
        verbose=not args.quiet,
        # disjoint reproducible stream per task (reference ntot/tid pattern)
        seed=args.seed * ntot + tid,
        batch=args.batch,
        init=args.init,
        device=rank_device(args.device),
    )
    np.save(out_file, as_numpy(x_gen))
    print(f"wrote {out_file}: {tuple(x_gen.shape)}")
    print("FINISHED")


if __name__ == "__main__":
    main()
