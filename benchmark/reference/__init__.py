"""Plain reference of Path Shadowing Monte Carlo, for the benchmark's check.

Direct search over every dataset window (embed, distance, k smallest),
the softmax-weighted realized-variance prediction (and its bounds over
float32 ties at the k-th winner) and the autoregressive linear benchmark,
written from their definitions in PyTorch and NumPy. It imports neither
JAX, the JAX package nor anything of ``shadowing_tpu_torch``, and takes
only the inputs the harness hands it.

Every function takes an :class:`~benchmark.reference.precision.Arith`:
``FLOAT64`` gives the reference's answer, ``TF32`` the control (the same
arithmetic with every product's operands rounded to TF32, accumulated in
float32), which the check must refuse.
"""
