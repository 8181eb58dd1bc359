"""CUDA backend (``--backend=cuda``): PyTorch on a CUDA card.

Counterpart of ``mpi_k_selection_tpu/backends/tpu.py``. Selection runs on
one device through the radix/sort ops (ops/); when the process belongs to
a group of two or more ranks and the input is large, it runs sharded over
the group's mesh through the distributed paths (parallel/), which replace
the reference's MPI scatter/iterate/gather protocol
(``TODO-kth-problem-cgm.c:103-293``) with ``torch.distributed``
collectives. The device count the planner sees is the current group's
size (1 with no group): a rank is a process with one device.
"""

from __future__ import annotations

import torch.distributed as dist

from mpi_k_selection_tpu_torch import api, config
from mpi_k_selection_tpu_torch.ops import topk as _topk

NAME = "cuda"


def group_size() -> int:
    """Ranks of the started process group, 1 with none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def plan(n: int, algorithm: str = "auto", distribute: str = "auto", n_dev: int | None = None):
    """Resolve ``(effective_algorithm, distributed)`` for a selection of
    size n, by the JAX package's rules.

    The radix and cgm algorithms have distributed paths, so an explicit
    ``algorithm='sort'`` always runs on one device and asking for
    ``distribute='always'`` with it is an error, not a silent switch. CGM
    is the reference's multi-rank protocol (``TODO-kth-problem-cgm.c``) and
    is *only* distributed: ``distribute='never'`` with it is an error (the
    reference's world_size >= 2 abort, ``:56-59``). ``n_dev`` is the mesh
    size the caller will run on (default: :func:`group_size`); N need not
    divide by it (the distributed paths pad with order-maximal sentinels,
    parallel/mesh.py:pad_to_multiple)."""
    if distribute not in ("auto", "never", "always"):
        raise ValueError(f"distribute={distribute!r} must be one of 'auto', 'never', 'always'")
    if n_dev is None:
        n_dev = group_size()

    def check_min_devices():
        # after the algorithm's own check, so a non-distributable algorithm
        # keeps its more specific error on a single device too
        if distribute == "always" and n_dev < config.MIN_DEVICES_DISTRIBUTED:
            raise ValueError(
                f"distribute='always' needs >= {config.MIN_DEVICES_DISTRIBUTED} devices, have {n_dev}"
            )

    if algorithm == "cgm":
        if distribute == "never":
            raise ValueError(
                "algorithm='cgm' is the distributed parity protocol and has "
                "no single-chip path (the reference aborts below 2 ranks, "
                "TODO-kth-problem-cgm.c:56-59); use algorithm='radix' or "
                "'sort' single-chip"
            )
        check_min_devices()
        return "cgm", True
    if algorithm not in api.ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; choose from {api.ALGORITHMS + ('cgm',)}")
    distributable = algorithm in ("auto", "radix")
    if distribute == "always" and not distributable:
        raise ValueError(
            f"algorithm={algorithm!r} has no distributed path; "
            "use algorithm='radix', 'cgm' (or 'auto') with distribute='always'"
        )
    check_min_devices()
    use_mesh = {
        "auto": distributable and n_dev > 1 and n >= 1 << 20,
        "never": False,
        "always": True,
    }[distribute]
    if use_mesh:
        return "radix", True
    return api.resolve_algorithm(algorithm, n), False


def kselect(x, k: int, *, algorithm: str = "auto", distribute: str = "auto", device=None, **kwargs):
    """Exact k-th smallest (1-indexed). ``distribute`` in {auto, never,
    always}; a distributed run goes over the group's mesh, each rank's
    shard on ``device``."""
    from mpi_k_selection_tpu_torch.parallel import mesh as mesh_lib

    n = mesh_lib.global_size(x)
    algorithm, use_mesh = plan(n, algorithm, distribute)
    if use_mesh:
        from mpi_k_selection_tpu_torch.parallel import cgm as pcgm, radix as pradix

        mesh = mesh_lib.make_mesh(device=device)
        if algorithm == "cgm":
            return pcgm.distributed_cgm_select(x, k, mesh=mesh, **kwargs)
        return pradix.distributed_radix_select(x, k, mesh=mesh, **kwargs)
    return api.kselect(x, k, algorithm=algorithm, device=device, **kwargs)


def plan_many(n: int, distribute: str = "auto", *, device=None):
    """The mesh multi-rank selection runs on, or None for one device: the
    kselect planner (radix is the only multi-rank algorithm) against the
    group's size."""
    _, use_mesh = plan(n, "radix", distribute)
    if not use_mesh:
        return None
    from mpi_k_selection_tpu_torch.parallel import make_mesh

    return make_mesh(device=device)


def kselect_many(x, ks, *, distribute: str = "auto", device=None, **kwargs):
    """Exact k-th smallest for every k in ``ks``, distributed over the
    group's mesh by the same planner as :func:`kselect`."""
    from mpi_k_selection_tpu_torch.parallel import mesh as mesh_lib

    mesh = plan_many(mesh_lib.global_size(x), distribute, device=device)
    if mesh is not None:
        from mpi_k_selection_tpu_torch.parallel import radix as pradix

        out = pradix.distributed_radix_select_many(x, ks, mesh=mesh, **kwargs)
        return api.restore_k_shape(out, ks)
    return api.kselect_many(x, ks, device=device, **kwargs)


def quantiles(x, qs, *, distribute: str = "auto", device=None, **kwargs):
    """Exact nearest-rank quantiles; distributes like :func:`kselect_many`."""
    from mpi_k_selection_tpu_torch.parallel import mesh as mesh_lib

    n = mesh_lib.global_size(x)
    mesh = plan_many(n, distribute, device=device)
    if mesh is None:
        return api.quantiles(x, qs, device=device, **kwargs)
    from mpi_k_selection_tpu_torch.parallel import radix as pradix

    return pradix.distributed_radix_select_many(x, api.quantile_ranks(qs, n), mesh=mesh, **kwargs)


def median(x, *, device=None, **kwargs):
    from mpi_k_selection_tpu_torch.parallel import mesh as mesh_lib

    return kselect(x, max(1, mesh_lib.global_size(x) // 2), device=device, **kwargs)


def batched_kselect(x, k, *, device=None):
    """Per-row exact k-th smallest along the last axis on one device."""
    return api.batched_kselect(x, k, device=device)


def batched_median(x, *, device=None):
    return api.batched_median(x, device=device)


def kselect_streaming(source, k: int, **kwargs):
    """Exact k-th smallest over a replayable chunk source, each chunk
    staged on one device in turn."""
    return api.kselect_streaming(source, k, **kwargs)


def topk(x, k: int, *, device=None, **kwargs):
    """Top-k along the last axis (values, int64 indices) on one device."""
    return _topk.topk(x, k, device=device, **kwargs)
