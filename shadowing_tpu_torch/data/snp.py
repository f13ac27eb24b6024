"""Bundled daily S&P-like price dataset.

Port of :mod:`shadowing_tpu.data.snp` on numpy alone (no pandas): the same
bundle (``_bundled/snp_daily.npz``, a byte copy of the JAX package's), with
``.dlnx`` of shape ``(1, 1, T)`` and ``.dts`` as a ``datetime64[D]`` array.
``start``/``end`` take day-first dates (``'03-01-2000'``, ``/`` or ``.``
separators also accepted) or ISO dates (``'2000-01-03'``).

The bundled series is a synthetic stand-in made by a seeded
path-dependent-volatility simulation, not market data (see the JAX module's
docstring for its provenance and file format).
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from shadowing_tpu_torch.data.price_data import PriceData

BUNDLE_PATH = Path(__file__).parent / "_bundled" / "snp_daily.npz"


def _parse_dayfirst(s: str) -> np.datetime64:
    parts = re.split(r"[-/.]", s.strip())
    if len(parts) != 3:
        raise ValueError(f"cannot parse date {s!r}: expected dd-mm-yyyy")
    if len(parts[0]) == 4:               # ISO year-month-day
        y, m, d = parts
    else:
        d, m, y = parts
    return np.datetime64(f"{int(y):04d}-{int(m):02d}-{int(d):02d}", "D")


class SPDaily(PriceData):
    """Daily S&P-like price data bundled with the package.

    :param start: optional first date (inclusive)
    :param end: optional last date (inclusive)
    """

    def __init__(self, start: str | None = None, end: str | None = None,
                 path: Path | str | None = None):
        bundle = np.load(Path(path) if path is not None else BUNDLE_PATH)
        dlnx = bundle["dlnx"]
        dts = bundle["days"].astype("datetime64[D]")
        x_init = float(bundle["x_init"])

        mask = np.ones(len(dts), dtype=bool)
        if start is not None:
            mask &= dts >= _parse_dayfirst(start)
        if end is not None:
            mask &= dts <= _parse_dayfirst(end)
        if not mask.any():
            raise ValueError(f"no data in range [{start}, {end}]")
        super().__init__(dlnx=dlnx[None, None, mask], x_init=x_init,
                         dts=dts[mask])
