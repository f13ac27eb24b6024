"""``generate``: each call is one task of the upstream generation job array
(closed loop, one caller): ``shadowing_tpu_torch.generate`` of the
configuration's ``R / ntot`` paths calibrated to its S&P span, in shards of
``batch`` seeds, with the cache off, so no call reads or writes a disk.

Call i of a run with ``--seed n`` is the job array's task ``i % ntot`` of
array seed ``n + i // ntot``: its generator seed is ``(n + i // ntot) *
ntot + i % ntot``, the CLI's, so no two calls of a run repeat a seed. The
warm-up and the traced call run only the first segment
(``optimizer.first_segment`` Adam steps) of one shard: the warm-up under a
seed of its own, the traced call as the first shard of the next task.

Traffic keys: ``check_paths`` (paths of every call compared with the
reference: the same rows in every call of a run, :func:`check_rows`),
``trace_calls``.

Numbers compared, over the checked paths of every call; ``rms`` is a
path's root mean squared mismatch of its scattering-spectra statistics
against the series', both on standardised series:

* ``rms_gap``: the largest gap between the rms the port reports for a path
  (of its float32 statistics and target) and the float64 reference's rms of
  the same path (``benchmark/reference/scattering.py``);
* ``unconverged_pct``: the share (%) of checked paths whose float64 rms is
  at or above the configuration's ``tol``, or not finite;
* ``paths_missing``: the largest gap, over the calls, between the task's
  ``R`` and the paths (or reported rms) the call returned;
* ``max_path_corr``: the largest absolute correlation between two checked
  paths, of one call or of two: a path made twice (half of a task copied
  into its other half, a shard's or a task's seed ignored) reads about 1,
  distinct draws under ``8 / sqrt(T)``.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark import datagen, traffic
from benchmark.reference import scattering

UNIT = "step"
NUMBERS = ("rms_gap", "unconverged_pct", "paths_missing", "max_path_corr")


def series(config: dict) -> np.ndarray:
    """The calibration series: the bundled daily log-returns between the
    configuration's dates, float64."""
    spec = config["series"]
    with np.load(datagen.SNP_PATH) as bundle:
        days = bundle["days"].astype("datetime64[D]")
        dlnx = np.asarray(bundle["dlnx"], np.float64)
    keep = (days >= np.datetime64(spec["start"])) & (days <= np.datetime64(spec["end"]))
    return dlnx[keep]


def task_paths(config: dict) -> int:
    return int(config["R"]) // int(config["ntot"])


class Tasks:
    """The window's calls, one job-array task each, made on demand."""

    def __init__(self, config: dict, tr: dict, seed: int):
        self.config, self.seed = config, int(seed)
        self.keep = check_rows(config, tr, seed)

    def __len__(self) -> int:
        return sys.maxsize

    def __getitem__(self, i: int) -> dict:
        ntot = int(self.config["ntot"])
        return {"seed": (self.seed + i // ntot) * ntot + i % ntot,
                "R": task_paths(self.config),
                "max_iterations": int(self.config["max_iterations"]),
                "keep": self.keep}


def check_rows(config: dict, tr: dict, seed: int) -> np.ndarray:
    """The checked rows of every call. The task is cut into parts of a
    shard each, or into halves where it is one shard; rows ``j`` of the
    last (smallest) part are drawn from the seed and each taken in every
    part (``j``, ``j + part``, ...), so that a part made twice shows within
    a call and a task made twice between calls."""
    R = task_paths(config)
    part = min(int(config["batch"]), -(-R // 2))
    parts = -(-R // part)
    last = R - (parts - 1) * part
    rng = np.random.default_rng(datagen.sub_seed(seed, "check"))
    j = rng.choice(last, size=min(int(tr["check_paths"]) // parts, last),
                   replace=False)
    return np.sort(np.concatenate([j + s * part for s in range(parts)]))


def _segment(config: dict, x: dict) -> dict:
    """``x`` cut to the first segment of its first shard."""
    n = int(config["batch"])
    return {**x, "R": n, "max_iterations": int(config["optimizer"]["first_segment"]),
            "keep": x["keep"][x["keep"] < n]}


def mix(config: dict, tr: dict, seed: int, device) -> traffic.Mix:
    tasks = Tasks(config, tr, seed)
    warm = {**tasks[0], "seed": datagen.sub_seed(seed, "warm")}
    return traffic.Mix(tasks, _segment(config, warm), task_paths(config))


def trace_input(mix: traffic.Mix, i: int) -> dict:
    return _segment(mix.pool.config, mix.inputs(i))


class Generation:
    """``shadowing_tpu_torch.generate`` on the configuration's series."""

    def __init__(self, config: dict, tr: dict, device):
        import shadowing_tpu_torch as st

        self.st, self.config, self.device = st, config, device
        self.series = series(config)

    def evidence(self) -> dict:
        return {"route": "generate", "batch": int(self.config["batch"])}


class Reference:
    """The plain reference: the statistics of the series and of paths in
    one arithmetic, and a synthesis built on them."""

    def __init__(self, config: dict, tr: dict, device, arith):
        self.config, self.device, self.arith = config, device, arith
        self.series = series(config)
        self.stats = scattering.Statistics(self.series, int(config["J"]),
                                           int(config["T"]), arith, device)

    def evidence(self) -> dict:
        return {"route": f"reference synthesis in {self.arith.name}"}


def program_system(config: dict, tr: dict, seed: int, device) -> Generation:
    return Generation(config, tr, device)


def oracle_system(config: dict, tr: dict, seed: int, device, arith) -> Reference:
    return Reference(config, tr, device, arith)


def _answer(paths: torch.Tensor, rms: np.ndarray, steps: int, x: dict) -> dict:
    """The answer's checked rows (those it has) and its shortfall."""
    rms = np.asarray(rms, np.float64)
    keep = x["keep"][x["keep"] < min(paths.shape[0], rms.size)]
    return {"paths": paths[torch.as_tensor(keep, device=paths.device)].double().cpu().numpy(),
            "rms": rms[keep], "rms_all": rms, "steps": int(steps),
            "missing": max(abs(x["R"] - paths.shape[0]), abs(x["R"] - rms.size))}


def program(system: Generation, x: dict) -> dict:
    cfg, logs = system.config, []
    paths = system.st.generate(
        system.series, R=x["R"], J=int(cfg["J"]), T=int(cfg["T"]),
        tol_optim=float(cfg["tol"]), max_iterations=x["max_iterations"],
        batch=int(cfg["batch"]), init=cfg["init"], seed=x["seed"],
        device=system.device, cache_path=None, shard_logs=logs)
    rms = np.concatenate([np.asarray(log["rms"]) for log in logs])
    return _answer(paths[:, 0], rms, sum(int(log["steps"]) for log in logs), x)


def oracle(system: Reference, x: dict) -> dict:
    """The task through the reference's synthesis, shard by shard, each
    seeded as the port seeds its shards."""
    cfg, n = system.config, int(system.config["batch"])
    paths, rms, steps = [], [], 0
    for i in range(-(-x["R"] // n)):
        gen = torch.Generator(device=system.device).manual_seed(int(
            np.random.SeedSequence([x["seed"], i]).generate_state(1, np.uint64)[0]))
        z, r, done = scattering.synthesize(system.stats, gen, n, cfg["optimizer"],
                                           float(cfg["tol"]), x["max_iterations"])
        paths.append(z)
        rms.append(r)
        steps += done
    s = system.series
    out = torch.cat(paths)[: x["R"]] * float(s.std()) + float(s.mean())
    return _answer(out, np.concatenate(rms)[: x["R"]], steps, x)


def trace_units(tr: dict) -> tuple:
    return int(tr["trace_calls"]), 1


def layer_units(outputs: list) -> int:
    """Adam steps the calls ran: per shard, the steps of its longest-running
    seed (``shard_logs``' ``steps``)."""
    return sum(o["steps"] for o in outputs)


def max_corr(paths: np.ndarray) -> float:
    """The largest absolute correlation between two of the rows."""
    z = paths - paths.mean(axis=1, keepdims=True)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    c = np.abs(z @ z.T)
    np.fill_diagonal(c, 0.0)
    return float(c.max()) if np.isfinite(c).all() else float("inf")


def _max(a: np.ndarray) -> float:
    return float(a.max()) if a.size else float("nan")


def readings(config: dict, tr: dict, ref: Reference, inputs: list,
             outputs: list, seed: int) -> dict:
    paths = np.concatenate([o["paths"] for o in outputs])
    got = np.concatenate([o["rms"] for o in outputs])
    want = ref.stats.rms(paths)
    gap = np.abs(got - want)
    tol = float(config["tol"])
    cut = np.cumsum([len(o["rms"]) for o in outputs])[:-1]
    print("generation per checked call: seed, Adam steps, reported rms median / "
          "max of all paths, float64 rms max of the checked, largest gap: " + ", ".join(
              f"{x['seed']}: {o['steps']}, {np.median(o['rms_all']):.4g} / "
              f"{o['rms_all'].max():.4g}, {_max(w):.4g}, {_max(g):.3g}"
              for x, o, w, g in zip(inputs, outputs, np.split(want, cut),
                                    np.split(gap, cut))), flush=True)
    return {"rms_gap": float(gap.max()) if np.isfinite(gap).all() else float("inf"),
            "unconverged_pct": 100.0 * float(np.mean(~(want < tol))),
            "paths_missing": float(max(o["missing"] for o in outputs)),
            "max_path_corr": max_corr(paths)}
