"""Seeded data, dtype transforms, interop, timing and checks."""

from mpi_k_selection_tpu_torch.utils import datagen, dtypes, timing

__all__ = ["datagen", "dtypes", "timing"]
