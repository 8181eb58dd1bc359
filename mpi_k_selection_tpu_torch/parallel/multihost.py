"""Process bootstrap and the rank launcher.

Counterpart of ``mpi_k_selection_tpu/parallel/multihost.py``. The reference
scales with ``mpirun -np P`` on one machine or a cluster, MPICH handling
bootstrap and transports. Here:

- bootstrap -> :func:`initialize` (``torch.distributed.init_process_group``;
  ``env://`` under ``torchrun``, which sets ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR`` and ``MASTER_PORT``), with the backend of
  :func:`~mpi_k_selection_tpu_torch.parallel.mesh.choose_backend` and a
  finite timeout;
- ``mpirun -np P`` on one host -> :func:`run_ranks`, which spawns P
  processes that meet in a file store in a temporary directory (no TCP
  port), calls ``fn(mesh, *args)`` on each and returns rank 0's result;
- rank/world -> :func:`process_index` / :func:`process_count`.

The communication of a selection is a few small collectives a pass, so a
flat 1-D mesh over every rank of the job is the layout
(:func:`make_global_mesh`); :func:`make_hybrid_mesh` still gives each rank
its host's group and its cross-host group for callers that reduce within
a host first. A failed rank fails the job, as the reference's abort does
(``TODO-kth-problem-cgm.c:56-59``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
import traceback

import torch
import torch.distributed as dist

from mpi_k_selection_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    Mesh,
    choose_backend,
    make_mesh,
    rank_device,
)
from mpi_k_selection_tpu_torch.utils.timing import Deadline


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    backend: str | None = None,
    device=None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the job: ``init_process_group`` with ``init_method`` (default
    ``env://``), the world size and rank (default: the ``WORLD_SIZE`` and
    ``RANK`` variables), and the backend :func:`choose_backend` gives for
    the ranks' ``device`` (default ``"cuda"``)."""
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    backend = choose_backend(world_size, "cuda" if device is None else device, backend)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
    )


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_global_mesh(*, device=None) -> Mesh:
    """Flat 1-D mesh over every rank of the job."""
    return make_mesh(device=device)


@dataclasses.dataclass(frozen=True)
class HybridMesh:
    """A rank's two groups: ``local`` (its host's ranks) and ``hosts`` (one
    rank of each host, those with its local index)."""

    hosts: Mesh
    local: Mesh


def make_hybrid_mesh(*, per_host: int | None = None, device=None) -> HybridMesh:
    """(hosts, ranks-per-host) groups of the job: a reduction over
    ``local`` stays on the host, the cross-host combine goes over
    ``hosts``. ``per_host`` defaults to ``LOCAL_WORLD_SIZE`` (torchrun),
    else the whole job. Every rank must call this, in the same order."""
    world, rank = process_count(), process_index()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world)) if per_host is None else per_host
    if per_host < 1 or world % per_host:
        raise ValueError(f"{world} ranks do not divide evenly over hosts of {per_host}")
    dev = rank_device(device, rank)
    backend = dist.get_backend() if dist.is_initialized() else None
    local = hosts = None
    for h in range(world // per_host):  # every rank creates every group
        g = dist.new_group(list(range(h * per_host, (h + 1) * per_host))) if world > 1 else None
        if rank // per_host == h:
            local = Mesh(g, rank % per_host, per_host, dev, backend)
    for i in range(per_host):
        g = dist.new_group(list(range(i, world, per_host))) if world > 1 else None
        if rank % per_host == i:
            hosts = Mesh(g, rank // per_host, world // per_host, dev, backend)
    return HybridMesh(hosts=hosts, local=local)


def host_local_result(value):
    """A replicated result on this host: a tensor comes back as NumPy (the
    analogue of the reference printing from rank 0; every rank holds it)."""
    if isinstance(value, torch.Tensor):
        from mpi_k_selection_tpu_torch.utils.interop import tensor_to_numpy

        return tensor_to_numpy(value)
    return value


def _rank_main(rank, world, store, backend, device, timeout, fn, args, reports):
    """One spawned rank: join the group, run ``fn(mesh, *args)``, report."""
    try:
        initialize(f"file://{store}", world, rank, backend=backend, device=device, timeout=timeout)
        try:
            out = fn(make_mesh(device=device), *args)
        finally:
            dist.destroy_process_group()
        reports.put((rank, None, out if rank == 0 else None))
    except BaseException:  # reported to the launcher, which raises it
        reports.put((rank, traceback.format_exc(), None))


def run_ranks(fn, world: int, *args, backend: str | None = None, device="cuda", timeout: float = DEFAULT_TIMEOUT_S):
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks (the ``mpirun
    -np P`` analogue) and return rank 0's result.

    ``fn`` and ``args`` go to the ranks by pickling: pass a module-level
    function and small arguments (a rank reads large data itself, e.g.
    from a memory map). Each rank's shard lives on ``device``
    (:func:`~mpi_k_selection_tpu_torch.parallel.mesh.rank_device`); for a
    CUDA device the kernels are built here first, so that the ranks do
    not all run ``nvcc``. Raises if a rank raises, dies or does not finish
    within ``timeout`` seconds, which also bounds each collective."""
    if world < 1:
        raise ValueError(f"world={world} must be >= 1")
    dev = torch.device(device)
    backend = choose_backend(world, dev, backend)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the ranks; pass device='cpu' to run on the CPU")
        from mpi_k_selection_tpu_torch.ops.cuda.build import build_all

        build_all()
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="kselect-ranks-") as tmp:
        reports = ctx.Queue()
        procs = [
            ctx.Process(
                target=_rank_main, name=f"kselect-rank-{r}",
                args=(r, world, os.path.join(tmp, "store"), backend, str(dev), timeout, fn, args, reports),
            )
            for r in range(world)
        ]
        for p in procs:
            p.start()
        try:
            return _collect(procs, reports, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            reports.close()


def _collect(procs, reports, timeout: float):
    """Rank 0's result once every rank has reported; raise on the first
    failure, on a rank that died without a report, or at the deadline."""
    deadline = Deadline.after(timeout)
    done = {}
    while len(done) < len(procs):
        left = deadline.remaining()
        if deadline.expired:
            missing = sorted(set(range(len(procs))) - set(done))
            raise TimeoutError(f"ranks {missing} did not finish within {timeout} s")
        try:
            rank, err, out = reports.get(timeout=min(left, 1.0))
        except queue.Empty:
            dead = [(r, p.exitcode) for r, p in enumerate(procs) if r not in done and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]} without a result") from None
            continue
        if err is not None:
            raise RuntimeError(f"rank {rank} failed:\n{err}")
        done[rank] = out
    return done[0]
