"""The benchmark of sparkfm_tpu_torch, the PyTorch and CUDA port.

One command runs one cell (a configuration under a traffic mix) once::

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads, warms up, measures for ``--seconds``, checks what the timed path
produced against the plain reference in ``portbench/reference/`` and prints
one JSON line. Cells, configurations, traffic mixes, the drivers of the
port's entry points and the per-layer metric readers are files found by the
names in ``BENCHMARK.json`` (``harness.py``). Nothing here imports ``jax``,
``jaxlib`` or the JAX package ``sparkfm_tpu``; the reference imports nothing
of the port either.
"""
