"""A RadixSketch of a sharded array, merged over the ranks
(counterpart of ``mpi_k_selection_tpu/parallel/sketch.py``).

The sketch's merge is an elementwise sum (streaming/sketch.py), so a
sketch of data spread over the ranks is each rank's count of its own
block, summed: the reference CGM's ``MPI_Allreduce`` of per-rank counts
(``TODO-kth-problem-cgm.c:190``), except that the reduced object is the
final queryable summary. :func:`distributed_sketch` counts each rank's
block of the global array (``parallel/mesh.py:shard_1d``) with the sweep
kernel's sketch part: the deepest level and the extremes in key space,
one launch per block of fewer than 2^31 keys (int32 counts), over the
block's real keys only (the sentinel pads of the last ranks are never
counted). One ``all_reduce`` sums the int64 deep counts and the counts of
keys; one ``all_reduce`` MIN takes both extremes, as biased signed
int64 (``key ^ 2^63``: signed order is the keys' unsigned order) with the
maximum carried as its complement. The shallower levels are derived on the
host. Every rank returns the same sketch, bit for bit the one that
``RadixSketch.update`` builds over the whole array.

:func:`dcn_merge_sketch` merges sketches that processes accumulated on
their own (each its own stream) with one ``all_gather`` of the deepest
level, the count and the extremes, packed as uint32 lo/hi words (the JAX
package's wire format, byte for byte; the lanes travel in an int32
container, ground rule 3 of ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_k_selection_tpu_torch.parallel import mesh as mesh_lib
from mpi_k_selection_tpu_torch.streaming.executor import SketchFoldConsumer
from mpi_k_selection_tpu_torch.streaming.pipeline import stage_chunk
from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch
from mpi_k_selection_tpu_torch.utils import dtypes as _dt

#: Keys a launch counts: its int32 counters stay exact below 2^31.
SEGMENT = 1 << 30

_BIAS = 1 << 63
_EMPTY_LANE = (1 << 63) - 1  # MIN's identity: the biased maximum key


def _wire(key: int) -> int:
    """A key (unsigned, up to 64 bits) as the int64 whose signed order is
    the keys' order."""
    return _dt.signed_const(key ^ _BIAS, 64)


def _unwire(w: int) -> int:
    return (w & ((1 << 64) - 1)) ^ _BIAS


def _split_u32(a: np.ndarray) -> np.ndarray:
    """A nonnegative int64/uint64 vector as a ``(2, n)`` uint32 lo/hi-word
    array: the wire format of :func:`dcn_merge_sketch`."""
    u = a.astype(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi])


def _join_u32(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_split_u32`: ``(2, n)`` uint32 -> uint64."""
    lo, hi = packed
    return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))


def _pack_sketch_payload(sk: RadixSketch) -> np.ndarray:
    """One process's payload: ``[deep histogram..., n, has_data, min_key,
    max_key]`` as uint64; ``has_data`` masks the extremes of a process
    that saw no data."""
    deep = sk.hists[-1]
    payload = np.empty((deep.size + 4,), np.uint64)
    payload[: deep.size] = deep.astype(np.uint64)
    payload[deep.size] = np.uint64(sk.n)
    payload[deep.size + 1] = np.uint64(sk.n > 0)
    payload[deep.size + 2] = np.uint64(0) if sk._min_key is None else np.uint64(sk._min_key)
    payload[deep.size + 3] = np.uint64(0) if sk._max_key is None else np.uint64(sk._max_key)
    return payload


def _unpack_gathered_payloads(gathered: np.ndarray, like: RadixSketch) -> RadixSketch:
    """Fold every process's packed ``(2, len)`` uint32 payload into a new
    sketch shaped ``like`` (a process without data adds nothing, to the
    extremes neither)."""
    nbuckets = like.hists[-1].size
    out = like._like()
    kmin = kmax = None
    for packed in gathered:
        row = _join_u32(packed)
        n_p = int(row[nbuckets])
        if not int(row[nbuckets + 1]):
            continue
        out._fold_deep_histogram(row[:nbuckets].astype(np.int64))
        out.n += n_p
        pmin = out.kdt.type(row[nbuckets + 2])
        pmax = out.kdt.type(row[nbuckets + 3])
        kmin = pmin if kmin is None else min(kmin, pmin)
        kmax = pmax if kmax is None else max(kmax, pmax)
    out._min_key, out._max_key = kmin, kmax
    return out


def dcn_merge_sketch(sk: RadixSketch, *, mesh=None) -> RadixSketch:
    """Merge the sketches each process of ``mesh`` (by default the started
    group) accumulated on its own, with ONE ``all_gather`` of the packed
    deepest levels; the shallower levels are derived again from the merged
    deepest one. Every process returns the merged sketch; without a group
    (one process) ``sk`` itself comes back."""
    if mesh is None:
        if not torch.distributed.is_initialized():
            return sk
        mesh = mesh_lib.make_mesh()
    if mesh.group is None or mesh.size == 1:
        return sk
    packed = _split_u32(_pack_sketch_payload(sk))
    gathered = mesh.all_gather(torch.from_numpy(packed.view(np.int32)).to(mesh.device))
    return _unpack_gathered_payloads(gathered.cpu().numpy().view(np.uint32), sk)


def distributed_sketch(x, *, mesh=None, radix_bits: int = 4, levels: int = 4) -> RadixSketch:
    """A :class:`RadixSketch` of the global 1-D ``x`` (a tensor, anything
    NumPy takes, or this rank's :class:`~mpi_k_selection_tpu_torch.
    parallel.mesh.Shard`) over ``mesh`` (every rank of the started group by
    default): each rank counts its block on its device, two
    ``all_reduce`` calls merge the counts and the extremes (see the module
    docstring). Every rank calls it with the same input and gets the same
    sketch."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    mesh_lib.require_distributed(mesh)
    if isinstance(x, mesh_lib.Shard):
        dtype, sentinel = x.block.dtype, x.sentinel
    else:
        dtype, sentinel = (x.dtype if isinstance(x, (torch.Tensor, np.ndarray)) else np.asarray(x).dtype), "max"
    sk = RadixSketch(dtype, radix_bits=radix_bits, levels=levels, device=mesh.device)
    shard = mesh_lib.shard_1d(x, mesh, sentinel=sentinel)
    per = shard.block.numel()
    start = min(mesh.rank * per, shard.n)
    n_valid = min(start + per, shard.n) - start
    block = shard.block[:n_valid]  # the pads are never counted
    local = sk._like()
    consumer = SketchFoldConsumer(local)
    tdt = _dt.torch_dtype(dtype)
    for off in range(0, n_valid, SEGMENT):
        keys = stage_chunk(block[off:off + SEGMENT], tdt, mesh.device)
        try:
            consumer.finish(consumer.dispatch(keys))
        finally:
            keys.release()
    counts = np.append(local.hists[-1], np.int64(local.n))
    total = mesh.all_reduce(torch.from_numpy(counts).to(mesh.device)).cpu().numpy()
    lanes = [_EMPTY_LANE, _EMPTY_LANE]
    if local.n:
        lanes = [_wire(int(local._min_key)), ~_wire(int(local._max_key))]
    lo, hi = mesh.all_reduce(torch.tensor(lanes, dtype=torch.int64, device=mesh.device), op="min").tolist()
    sk._fold_deep_histogram(total[:-1])
    sk.n = int(total[-1])
    if sk.n:
        sk._min_key, sk._max_key = sk.kdt.type(_unwire(lo)), sk.kdt.type(_unwire(~hi))
    return sk
