"""``hedged_mc_smile_roofline.query``: share (%) of its roofline that the
Hedged-MC smile's kernel (``hedged_mc_smile``) reaches per query, its work
counted by ``benchmark.work_smile`` at the shapes of the cell this metric
lists (a reading does not name its cell); nothing where the kernel did not
run."""
from benchmark import harness, trace, work_smile

NAME = "hedged_mc_smile_roofline.query"
KERNEL = "hedged_mc_smile"


def read(r: trace.Reading):
    seconds = r.kernel_seconds((KERNEL,))
    if r.unit != "query" or seconds <= 0:
        return None
    bench = harness.manifest()
    metric = next(m for m in bench["per_layer"] if m["name"] == NAME)
    if len(metric["workloads"]) != 1:
        raise ValueError(f"{NAME} counts its work at the shapes of the one "
                         f"cell it lists, and it lists {metric['workloads']}")
    cell = harness.load_cell(metric["workloads"][0], bench)
    cfg, tr = cell.config, cell.traffic
    nbytes, flops = work_smile.smile(1, int(tr["k"]), int(cfg["horizon"]),
                                     cfg["Ts"], len(tr["Ms"]))
    bound, _ = work_smile.bound_seconds(nbytes, flops)
    return 100.0 * bound / (seconds / r.units)
