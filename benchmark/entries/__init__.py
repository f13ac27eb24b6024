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

An entry that is not a search brings its own system with optional hooks
(``benchmark/harness.py`` runs the search's defaults where they are
missing, and then needs ``contexts_per_search``):

* ``program_system(config, traffic, seed, device)``: the system under
  test, and ``oracle_system(config, traffic, seed, device, arith)``: the
  plain reference in ``arith``. Each has ``evidence()``, and may have
  ``shape`` (its dataset's), ``after_call()``, ``launches()`` (counters by
  kernel) and ``close()`` (frees its state);
* ``work(config, traffic, shape)``: the measured layer's ``(bytes,
  flops)`` per unit, or ``None``; without it and without
  ``contexts_per_search`` the benchmark counts none;
* ``layer_units(outputs)``: the per-layer units that the calls with these
  outputs completed, where ``trace_units``'s fixed count does not hold;
* ``trace_input(mix, i)``: the input of the i-th traced call, where it is
  not the mix's next; the same calls then run once untraced just before
  the profile, and give the untraced seconds per unit.
"""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")
