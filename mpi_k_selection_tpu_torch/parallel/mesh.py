"""The mesh: a process group, one process per rank.

Counterpart of ``mpi_k_selection_tpu/parallel/mesh.py``. JAX's mesh has one
controller driving every device; PyTorch's idiom, and the reference's own
model (``MPI_Init/Comm_size/Comm_rank``, ``TODO-kth-problem-cgm.c:53-61``),
is one process per rank. A :class:`Mesh` is one rank's view of a 1-D
mesh: the process group, the rank, the size, the device its shard and
kernels live on, and the group's backend. Every rank calls the distributed
entry points with the same global input, as under SPMD; :func:`shard_1d`
moves only this rank's block to its device (the ``MPI_Scatterv``
analogue, ``TODO-…:103``). The reference's ``world_size >= 2`` guard
(``MPI_Abort`` at ``TODO-…:56-59``) is :func:`require_distributed`.

The backend is ``nccl`` when each rank has a card of its own, else
``gloo`` (:func:`choose_backend`, decided before the group starts and
never after an error). The collectives' route is fixed by the backend:

- ``nccl``: the collective runs on the device tensors.
- ``gloo``: every collective stages its bytes through host memory (a copy
  to the host, the collective, a copy back). Gloo's own CUDA path copies
  to the host as well and does not take every collective and dtype, and
  the messages here are a few hundred bytes to a few hundred KB: a pass's
  histogram, the collect's candidates, a CGM round's scalars.

Without a started process group :func:`make_mesh` gives a mesh of size 1
(collectives are the identity), so :func:`require_distributed` refuses it
with the JAX package's message.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from mpi_k_selection_tpu_torch import config
from mpi_k_selection_tpu_torch.utils import dtypes as _dt
from mpi_k_selection_tpu_torch.utils.timing import Stopwatch

DEFAULT_TIMEOUT_S = 600.0  # every group's bound on a collective: a diverged rank fails, never hangs
BACKENDS = ("gloo", "nccl")


def choose_backend(world: int, device="cuda", requested: str | None = None) -> str:
    """The process-group backend for ``world`` ranks whose shards live on
    ``device``: ``nccl`` when every rank has a card of its own, ``gloo``
    otherwise (more ranks than cards, or the CPU). Asking for ``nccl``
    with fewer cards than ranks, or on the CPU, raises."""
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if requested is None:
        return "nccl" if dev.type == "cuda" and cards >= world else "gloo"
    if requested not in BACKENDS:
        raise ValueError(f"unknown process-group backend {requested!r}; choose from {BACKENDS}")
    if requested == "nccl" and cards < world:
        raise ValueError(
            f"nccl needs a card for each rank: {world} ranks, {cards} CUDA cards "
            f"for device {str(dev)!r}; use gloo"
        )
    return requested


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``'s shard: ``device`` as given when it names an
    index or the CPU, else card ``LOCAL_RANK`` (or ``rank``) modulo the
    cards, so ranks past the card count share cards. No card raises:
    nothing falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the mesh; pass device='cpu' to run on the CPU")
    if dev.index is not None:
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())


class Mesh:
    """One rank's view of a 1-D mesh over a process group (None: one rank,
    no group). ``collectives`` counts the collectives this rank took part
    in and :meth:`collective_seconds` their time since the last
    :meth:`reset_stats`."""

    def __init__(self, group, rank: int, size: int, device, backend: str | None):
        if backend == "nccl" and torch.device(device).type != "cuda":
            raise ValueError("an nccl mesh needs CUDA devices")
        self.group = group
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.backend = backend
        self.reset_stats()

    def __repr__(self) -> str:
        return f"Mesh(rank={self.rank}, size={self.size}, device={self.device}, backend={self.backend})"

    def reset_stats(self) -> None:
        self._host = Stopwatch()
        self._events = []  # nccl: (start, end) CUDA events around each collective

    @property
    def collectives(self) -> int:
        return self._host.count + len(self._events)

    def collective_seconds(self) -> float:
        """Time in collectives: host seconds of gloo's blocking calls on
        staged tensors (the copies excluded); CUDA-event time of nccl's."""
        if self._events:
            self._events[-1][1].synchronize()
        return self._host.seconds + sum(a.elapsed_time(b) for a, b in self._events) / 1e3

    def _run(self, op, t: torch.Tensor):
        """Run ``op`` (a collective taking a tensor of the backend's route)
        on ``t``; return its result on ``t``'s device."""
        if self.backend == "nccl":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = op(t)
            b.record()
            self._events.append((a, b))
            return out
        host = t.to("cpu")  # waits for the work that produced t: not collective time
        with self._host.timing():
            out = op(host)
        return out.to(t.device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op="sum"``) or the minimum (``"min"``) of ``t``
        (int32/int64) over the ranks, on ``t``'s device (the
        ``MPI_Allreduce``/``lax.psum``/``lax.pmin`` analogue)."""
        if self.group is None:
            return t
        reduce_op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op]

        def reduce(u):
            u = u.clone()
            dist.all_reduce(u, op=reduce_op, group=self.group)
            return u

        return self._run(reduce, t.contiguous())

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order, shape ``(size, *t.shape)``,
        on ``t``'s device; any dtype (moved as bytes)."""
        if self.group is None:
            return t[None]
        shape, dtype = t.shape, t.dtype
        raw = t.contiguous().reshape(-1).view(torch.uint8)

        def op(u):
            parts = [torch.empty_like(u) for _ in range(self.size)]
            dist.all_gather(parts, u, group=self.group)
            return torch.stack(parts)

        return self._run(op, raw).view(dtype).reshape(self.size, *shape)

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def make_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """This rank's mesh over the started process group (size 1 when none
    has started). ``n_devices`` must be the group's size: a rank owns one
    device, so a smaller mesh is a smaller job (start that many ranks).
    ``device`` (default: a CUDA card, :func:`rank_device`) holds this
    rank's shard."""
    if dist.is_initialized():
        group, rank, size, backend = dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dist.get_backend()
    else:
        group, rank, size, backend = None, 0, 1, None
    if n_devices is not None and n_devices != size:
        if n_devices > size:
            raise ValueError(f"requested {n_devices} devices, have {size}")
        raise ValueError(
            f"requested {n_devices} devices of a group of {size} ranks: one process drives one "
            f"device, so start {n_devices} ranks (parallel/multihost.py:run_ranks)"
        )
    return Mesh(group, rank, size, rank_device(device, rank), backend)


def require_distributed(mesh: Mesh) -> None:
    """Mirror of the reference's world_size >= 2 guard (TODO-…:56-59)."""
    if mesh.size < config.MIN_DEVICES_DISTRIBUTED:
        raise ValueError(
            f"distributed selection needs >= {config.MIN_DEVICES_DISTRIBUTED} "
            f"devices, got {mesh.size} (reference aborts the same way: "
            "TODO-kth-problem-cgm.c:56-59)"
        )


def _sentinels(count: int, dtype, device, which: str) -> torch.Tensor:
    """``count`` copies of ``dtype``'s order-maximum (``"max"``) or
    order-minimum (``"min"``) in key order."""
    bits = _dt.key_bits(dtype)
    key = _dt.max_key(bits) if which == "max" else 0
    return _dt.from_sortable_bits(torch.full((count,), key, dtype=_dt.key_dtype(dtype), device=device), dtype)


def pad_to_multiple(x: torch.Tensor, multiple: int):
    """Pad 1-D ``x`` to a multiple of ``multiple`` with order-maximal
    sentinels; returns ``(padded, n)``.

    The balanced-block analogue of ``TODO-…:81-100``: equal shards, with
    the first ranks' extra elements replaced by keys that are all ones
    (the dtype's order-maximum). Safe for selection as long as 1 <= k <=
    len(x): the sentinels occupy only the top ranks."""
    n = x.shape[0]
    rem = n % multiple
    if rem == 0:
        return x, n
    return torch.cat([x, _sentinels(multiple - rem, x.dtype, x.device, "max")]), n


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's block of a global 1-D array, on the rank's device: what
    :func:`shard_1d` returns, and what the distributed entry points take in
    place of the global array when the data is placed already (the JAX
    package's pre-sharded ``jax.Array``). ``n`` is the global size before
    padding, ``sentinel`` the padding's kind."""

    block: torch.Tensor
    n: int
    rank: int
    size: int
    sentinel: str = "max"


def global_size(x) -> int:
    """Element count of a global input (a :class:`Shard`'s unpadded
    global size, a tensor, or anything NumPy takes)."""
    if isinstance(x, Shard):
        return x.n
    return x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))


def shard_1d(x, mesh: Mesh, *, sentinel: str = "max") -> Shard:
    """This rank's block of the global 1-D ``x`` (a tensor, a NumPy array
    or memory map, anything NumPy takes), padded as :func:`pad_to_multiple`
    pads the whole (``sentinel="min"``: with order-minimal keys, the
    losers of a largest-k), on ``mesh.device``. The blocks are the JAX
    package's ``NamedSharding`` blocks; only this rank's block is read or
    copied. A :class:`Shard` of this mesh passes through."""
    if isinstance(x, Shard):
        if (x.rank, x.size, x.block.device) != (mesh.rank, mesh.size, mesh.device):
            raise ValueError(f"a shard of rank {x.rank} of {x.size} on {x.block.device} given to {mesh}")
        if x.sentinel != sentinel and x.block.numel() * x.size != x.n:
            raise ValueError(f"this call pads with {sentinel!r} sentinels; the shard was padded with {x.sentinel!r}")
        return x
    n = global_size(x)
    per = -(-n // mesh.size)
    start = min(mesh.rank * per, n)
    stop = min(start + per, n)
    if isinstance(x, torch.Tensor):
        block = x.reshape(-1)[start:stop].to(mesh.device)
    else:
        from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy

        part = np.asarray(x).reshape(-1)[start:stop]
        # a read-only block (a memory map) is read once into memory: torch
        # keeps no tensor over memory it may not write
        block = tensor_from_numpy(part if part.flags.writeable else np.array(part), mesh.device)
    pad = per - (stop - start)
    if pad:
        block = torch.cat([block, _sentinels(pad, block.dtype, mesh.device, sentinel)])
    return Shard(block, n, mesh.rank, mesh.size, sentinel)
