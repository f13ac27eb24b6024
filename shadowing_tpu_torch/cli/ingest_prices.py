"""Ingest a real daily price CSV into the bundled-dataset format.

Port of :mod:`shadowing_tpu.cli.ingest_prices` on the standard library and
numpy (no pandas). A user with a real series (any ``date,close`` CSV, e.g.
an S&P 500 daily export) feeds it to the generation workflow in one
command::

    python -m shadowing_tpu_torch.cli.ingest_prices prices.csv snp_daily.npz
    python -m shadowing_tpu_torch.cli.snp_generation --data snp_daily.npz ...

or points the class at it directly: ``SPDaily(path="snp_daily.npz")``.

Dates are ISO (``2014-12-31``, ``2014/12/31``, optionally followed by a
time) or ``mm-dd-yyyy`` (``dd-mm-yyyy`` with ``--dayfirst``), with ``-``,
``/`` or ``.`` separators.

Output schema (``data/snp.py``): ``{'dlnx': (T,) float64 log-returns,
'days': (T,) int64 days-since-epoch of each RETURN date (the first price
date anchors ``x_init`` and is dropped), 'x_init': float first price}``.
"""
from __future__ import annotations

import argparse
import csv
import re
from pathlib import Path

import numpy as np


def _parse_date(s: str, dayfirst: bool) -> np.datetime64:
    head = re.split(r"[T ]", s.strip(), maxsplit=1)[0]
    parts = re.split(r"[-/.]", head)
    if len(parts) != 3 or not all(p.isdigit() for p in parts):
        raise ValueError(f"cannot parse date {s!r}")
    if len(parts[0]) == 4:
        y, m, d = parts
    elif dayfirst:
        d, m, y = parts
    else:
        m, d, y = parts
    return np.datetime64(f"{int(y):04d}-{int(m):02d}-{int(d):02d}", "D")


def _parse_close(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        return float("nan")


def ingest_csv(
    csv_path: Path | str,
    out_path: Path | str,
    date_col: str = "date",
    close_col: str = "close",
    dayfirst: bool = False,
) -> Path:
    """Convert a ``date,close`` CSV into the ``snp_daily.npz`` schema.

    Rows are sorted by date; duplicate dates and non-positive or missing
    closes are rejected (a silent drop would shift every return).
    """
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
        header = rows[0].keys() if rows else []
    cols = {c.lower().strip(): c for c in header}
    try:
        date_c, close_c = cols[date_col.lower()], cols[close_col.lower()]
    except KeyError as e:
        raise ValueError(
            f"column {e.args[0]!r} not in CSV (has: {list(header)})"
        ) from None
    close = np.array([_parse_close(r[close_c] or "") for r in rows])
    if np.isnan(close).any():
        bad = rows[int(np.flatnonzero(np.isnan(close))[0])][date_c]
        raise ValueError(f"non-numeric/missing close (first at {bad!r})")
    dts = np.array([_parse_date(r[date_c], dayfirst) for r in rows],
                   dtype="datetime64[D]")
    order = np.argsort(dts, kind="stable")
    dts, x = dts[order], close[order]
    dup = dts[1:] == dts[:-1]
    if dup.any():
        raise ValueError(f"duplicate dates (first: {dts[1:][dup][0]})")
    if (x <= 0).any():
        raise ValueError("non-positive close prices cannot be log-priced")
    if len(x) < 2:
        raise ValueError("need at least two prices to form a return")

    dlnx = np.diff(np.log(x))
    days = dts[1:].astype(np.int64)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, dlnx=dlnx, days=days, x_init=float(x[0]))
    return out_path


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("csv", type=Path, help="input CSV with date,close columns")
    p.add_argument("out", type=Path, help="output .npz (snp_daily schema)")
    p.add_argument("--date-col", default="date")
    p.add_argument("--close-col", default="close")
    p.add_argument("--dayfirst", action="store_true",
                   help="parse dates day-first (e.g. 31-12-2014)")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    out = ingest_csv(args.csv, args.out, date_col=args.date_col,
                     close_col=args.close_col, dayfirst=args.dayfirst)
    d = np.load(out)
    first = np.datetime64(int(d["days"][0]), "D")
    last = np.datetime64(int(d["days"][-1]), "D")
    print(f"wrote {out}: {len(d['dlnx'])} daily returns, "
          f"{first} .. {last}, x_init={float(d['x_init']):g}")


if __name__ == "__main__":
    main()
