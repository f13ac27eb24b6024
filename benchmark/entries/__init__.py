"""Entries: what one call of a cell's closed loop does, by the name a
traffic file gives in ``entry``.

An entry module defines:

* ``UNIT``: the unit the per-layer metrics count (``"chunk"``, ``"query"``);
* ``NUMBERS``: the names of the numbers its check compares;
* ``mix(config, traffic, seed, device)``: the run's inputs
  (:class:`benchmark.traffic.Mix`);
* ``program(system, x)`` and ``oracle(oracle, x)``: one call through the
  port (:class:`benchmark.system.Program`) or the plain reference
  (:class:`benchmark.system.Oracle`), as a dict of host arrays;
* ``trace_units(traffic)``: ``(calls, units per call)`` of a traced run;
* ``contexts_per_search(traffic)``: the ``B`` of each pass-1 search;
* ``readings(config, traffic, oracle, inputs, outputs, seed)``: the
  check's numbers over a sample of the window's calls.
"""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")
