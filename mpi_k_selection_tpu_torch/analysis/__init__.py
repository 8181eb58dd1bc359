"""The port's static analyzer: the counterpart of
``mpi_k_selection_tpu/analysis/``, pointed at ``mpi_k_selection_tpu_torch/``.

Two engines:

1. **AST rules** (``KSLxxx``): ast_rules.py, concurrency.py (KSL015-017),
   lifecycle.py (KSL019-021) and placement.py (KSL022-024), pure
   syntax-tree passes over the port's source, with per-line suppressions
   (core.py: ``# ksel-torch: noqa[KSLxxx] -- why``).
2. **Torch contracts** (``KSCxxx``, contracts.py): the counterparts of the
   JAX package's jaxpr contracts, run on the port's kernels (their plain
   versions on the CPU, the CUDA kernels on a card).

Beside them, lockorder.py is the runtime lock-order sanitizer, whose
observed graph a flight bundle carries (obs/flight.py).

Run it::

    python -m mpi_k_selection_tpu_torch.analysis mpi_k_selection_tpu_torch

The rule catalog is docs/TORCH_ANALYSIS.md. The tier-1 tests run the
analyzer over the port and fail on any unsuppressed finding or stale
suppression (tests/test_torch_analysis.py).
"""

from mpi_k_selection_tpu_torch.analysis.core import (
    Finding,
    Report,
    Rule,
    iter_python_files,
    load_module,
    run_analysis,
)
from mpi_k_selection_tpu_torch.analysis import ast_rules as _ast_rules  # registers KSL rules
from mpi_k_selection_tpu_torch.analysis import concurrency as _concurrency  # KSL015-017
from mpi_k_selection_tpu_torch.analysis import lifecycle as _lifecycle  # KSL019-021
from mpi_k_selection_tpu_torch.analysis import placement as _placement  # KSL022-024
from mpi_k_selection_tpu_torch.analysis.concurrency import build_concurrency_report
from mpi_k_selection_tpu_torch.analysis.contracts import CONTRACT_CHECKS, run_contracts
from mpi_k_selection_tpu_torch.analysis.core import all_rules
from mpi_k_selection_tpu_torch.analysis.lifecycle import build_lifecycle_report
from mpi_k_selection_tpu_torch.analysis.lockorder import LockOrderSanitizer
from mpi_k_selection_tpu_torch.analysis.modcache import shared_modules
from mpi_k_selection_tpu_torch.analysis.placement import build_placement_report
from mpi_k_selection_tpu_torch.analysis.reporters import render_json, render_text

__all__ = [
    "Finding",
    "Report",
    "Rule",
    "run_analysis",
    "run_contracts",
    "all_rules",
    "iter_python_files",
    "load_module",
    "CONTRACT_CHECKS",
    "LockOrderSanitizer",
    "build_concurrency_report",
    "build_lifecycle_report",
    "build_placement_report",
    "shared_modules",
    "render_json",
    "render_text",
]
