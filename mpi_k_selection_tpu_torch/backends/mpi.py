"""MPI-parity backend (``--backend=mpi``): multi-process CGM selection.

Reproduces the reference's CGM weighted-median k-selection
(``TODO-kth-problem-cgm.c:35-296``) as P local OS processes communicating
through the native shared-memory collectives runtime
(native/kselect_native.cpp), the in-tree stand-in for the MPICH
``libmpi.so.12`` the reference links. Host only: int32, like the
reference's C int.
"""

from __future__ import annotations

import numpy as np

from mpi_k_selection_tpu_torch.native import cgm_driver

NAME = "mpi"


def kselect(x, k: int, *, num_procs: int = 4, **kwargs):
    return cgm_driver.kselect(x, k, num_procs=num_procs, **kwargs)


def median(x, **kwargs):
    x = np.asarray(x).ravel()
    return kselect(x, max(1, x.size // 2), **kwargs)
