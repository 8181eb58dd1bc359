"""Native (C++) runtime: the sequential selection engine and the
multi-process CGM collectives, the compiled layer that mirrors the
reference's gcc/MPICH binaries (``seq``, ``todo``). The port's own copy of
``kselect_native.cpp``, built here with ``g++``; see that file."""

from mpi_k_selection_tpu_torch.native import cgm_driver, loader  # noqa: F401
