"""Run one benchmark cell once and print its result as the last line.

    python3 kbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the port (``mpi_k_selection_tpu_torch``)
and ``BENCHMARK.json`` are found beside this directory.
"""

import pathlib
import sys

if __name__ == "__main__":
    # the checkout's root, not this directory: its modules would shadow top-level names
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])
    from kbench import clock

    t_start = clock.now()
    from kbench import harness

    sys.exit(harness.main(t_start=t_start))
