"""Distributed top-k over a mesh.

Counterpart of ``mpi_k_selection_tpu/parallel/topk.py``. The reference
returns only the k-th order statistic; top-k is the north star's
extension. Each rank takes the top-k of its shard on its device
(ops/topk.py), one ``all_gather`` moves the ``k`` candidates of every
rank (values and global indices, not the data), and a top-k of the
``P * k`` candidates gives the exact global result: the global top-k is a
subset of the union of the shards' top-k sets. The candidates arrive in
rank order and each rank's list is ordered by key then position, so the
final top-k's ties go by ascending global position, as the JAX package's.
Communication: ``P * k`` values and indices whatever N, the analogue of
the reference's medians gather (``TODO-kth-problem-cgm.c:135-136``) with
k values a rank instead of one.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_k_selection_tpu_torch.ops.topk import topk as local_topk
from mpi_k_selection_tpu_torch.parallel import mesh as mesh_lib
from mpi_k_selection_tpu_torch.utils import debug as _debug, dtypes as _dt


def _host_bits(x, mesh) -> np.ndarray:
    """The global input's bit patterns on the host; from a
    :class:`~mpi_k_selection_tpu_torch.parallel.mesh.Shard`, every rank's
    block gathered (the rare remap path only)."""
    if isinstance(x, mesh_lib.Shard):
        xh = mesh.all_gather(x.block).reshape(-1)[: x.n].cpu()
    elif isinstance(x, torch.Tensor):
        xh = x.reshape(-1).cpu()
    else:
        from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy

        xh = tensor_from_numpy(np.asarray(x).reshape(-1), "cpu")
    return _dt.bit_view(xh).numpy()


def _remap_sentinel_indices(xb: np.ndarray, n: int, vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Repair indices that point at padding slots (>= n).

    A padding sentinel enters the result only by *tying* a real element at
    the dtype's order-extreme value (it is a loser otherwise), and since
    n >= k there are at least as many real occurrences of that value as
    result slots holding it, so each bad slot maps to a distinct real
    occurrence. Rare; on the host, O(n). Matches raw bit patterns, not
    ``==``: a sentinel tie is key equality, which is bit equality (and a
    float sentinel is a NaN, which ``==`` never matches)."""
    idx_np = idx.cpu().numpy().copy()
    bad = np.flatnonzero(idx_np >= n)
    vb = _dt.bit_view(vals).cpu().numpy()
    for v in np.unique(vb[bad]):
        occ = np.flatnonzero(xb == v)
        taken = set(idx_np[(vb == v) & (idx_np < n)].tolist())
        free = iter(i for i in occ.tolist() if i not in taken)
        fallback = int(occ[0]) if occ.size else n - 1
        for slot in bad[vb[bad] == v]:
            idx_np[slot] = next(free, fallback)
    return torch.as_tensor(idx_np, dtype=idx.dtype, device=idx.device)


def distributed_topk(x, k: int, *, largest: bool = True, mesh=None, method: str = "auto"):
    """Exact global top-k of the global 1-D ``x`` over ``mesh``: every rank
    calls it with the same ``x`` (or its own
    :class:`~mpi_k_selection_tpu_torch.parallel.mesh.Shard`, padded with
    the losers named below) and gets ``(values, global int64
    indices)``, sorted by rank (ties by ascending position), on its
    device. ``method`` is the shards' local top-k method (ops/topk.py).

    Exact in values and indices: when n is not a multiple of the mesh
    size the shards are padded with losers (the order-minimum for the
    largest, the order-maximum for the smallest), and where the input
    holds that extreme value a pad can tie a real element into the
    result; such indices are remapped to a real occurrence of the value."""
    mesh = mesh_lib.make_mesh() if mesh is None else mesh
    mesh_lib.require_distributed(mesh)
    n = mesh_lib.global_size(x)
    _debug.check_concrete_k(k, n)
    if k > n // mesh.size:
        # a shard's top-k cannot exceed the shard; tiny inputs are not
        # worth distributing anyway
        raise ValueError(
            f"k={k} exceeds the shard size {n // mesh.size}; "
            "use the single-chip ops.topk for k this large"
        )
    shard = mesh_lib.shard_1d(x, mesh, sentinel="min" if largest else "max").block
    vals, idx = local_topk(shard, k, largest=largest, method=method)
    gidx = idx + mesh.rank * shard.numel()  # balanced equal shards
    cand_v = mesh.all_gather(vals).reshape(-1)  # (P*k,)
    cand_i = mesh.all_gather(gidx).reshape(-1)
    top_v, pos = local_topk(cand_v, k, largest=largest)
    top_i = cand_i[pos]
    # one host read, of gathered values: every rank takes the same branch
    if shard.numel() * mesh.size != n and bool((top_i >= n).any()):
        top_i = _remap_sentinel_indices(_host_bits(x, mesh), n, top_v, top_i)
    return top_v, top_i
