"""Benchmark of ``shadowing_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
object as its last line. Every configuration, traffic mix, limit file and
per-layer metric is a file of its own under this folder, found by the name
that ``BENCHMARK.json`` gives it. Nothing here imports JAX or the JAX
package; ``reference/`` imports nothing of the port either.
"""
