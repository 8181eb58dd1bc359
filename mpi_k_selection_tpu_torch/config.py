"""Framework defaults, carrying over the reference's compile-time constants
(the port's copy of ``mpi_k_selection_tpu/config.py``'s selection
constants).

The reference's parameters are compile-time constants
(``kth-problem-seq.c:7,24``; ``TODO-kth-problem-cgm.c:44-48``); here they
are the defaults of the CLI (cli.py).
"""

REFERENCE_K_SEQ = 250  # kth-problem-seq.c:24
REFERENCE_K_CGM = 150  # TODO-kth-problem-cgm.c:48

DEFAULT_SEED = 0
REFERENCE_N = 100_000_000  # SIZE_OF_SAMPLES (kth-problem-seq.c:7) == MAX_NUMBERS (TODO-…:46)
REFERENCE_C = 500  # CGM coarseness constant c (TODO-kth-problem-cgm.c:44)

# The CGM program aborts unless world_size >= 2 (TODO-kth-problem-cgm.c:56-59).
MIN_DEVICES_DISTRIBUTED = 2
