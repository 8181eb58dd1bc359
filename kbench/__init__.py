"""The benchmark of ``mpi_k_selection_tpu_torch``, the PyTorch / CUDA port.

One run is one cell (``BENCHMARK.json``'s ``workloads``) once, in a fresh
process::

    python3 kbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, op kind or
per-layer metric lives in a file of its own, found by name:

- ``configs/<config>.json``: a deployment (dtype, shape, key distribution,
  the precision of the control, what was assumed);
- ``cells/<cell>.json``: a traffic mix (the op kind and its parameters);
- ``ops/<kind>.py``: how one op kind drives the port (its inputs, queries,
  warm-up and the call);
- ``reference/<kind>.py``: the plain PyTorch reference of that op kind and
  the comparison that decides ``correct``;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

The generic parts are ``harness.py`` (set-up, window, check, result line),
``manifest.py`` (names to files), ``gen.py`` (seeded inputs), ``work.py``
(bytes a query or a launch needs, the device peaks), ``trace.py`` (the
profiler trace, counted before it is divided) and ``stats.py``. Nothing here
imports JAX, the JAX package, or the port's plain kernels and test helpers.
"""
