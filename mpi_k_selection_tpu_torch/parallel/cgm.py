"""Distributed CGM weighted-median k-selection — the reference-parity protocol.

Counterpart of ``mpi_k_selection_tpu/parallel/cgm.py``, itself the
reference's main artifact (``TODO-kth-problem-cgm.c:35-296``). Step by
step:

==============================================  ===============================
reference (MPI, physical discards)              here (a process group)
==============================================  ===============================
``MPI_Scatterv`` root->all ``:103``             ``shard_1d``: this rank's block
local ``qsort`` of the shard ``:115``           one ``torch.sort`` of the keys
local median of live elements ``:125-132``      the sorted window's middle
two ``MPI_Gather`` of (median, count)           one ``all_gather`` of the pair
``:135-136`` (the author's TODO ``:107-112``    (the fusion the author left
wanted them fused)                              as TODO)
rank-0 weighted median ``:139-165`` +           the same weighted median on
``MPI_Bcast(M)`` ``:168``                       every rank
linear L/E/G count sweep ``:175-185``           two ``torch.searchsorted``
``MPI_Allreduce(leg,3,SUM)`` ``:190``           one ``all_reduce`` of the 3
exact-hit test ``L < k <= L+E`` ``:194-201``    identical; one host read of it
``VecErase`` physical discard sweeps            the window shrinks:
``:204-225``                                    ``[lo, hi) -> [lo, lb)`` or
                                                ``[rb, hi)``, order kept
final Gatherv + sequential finish ``:236-280``  not needed: the exact test
                                                always fires
==============================================  ===============================

The JAX package's two repairs hold here too: the shard stays sorted, so
the window's middle is the exact local median every round, and there is
no sequential finish (the pivot is a live element, so E >= 1 and every
round discards at least one element). The round count equals the JAX
package's on the same mesh size: the stable argsort of the medians, the
int64 running weights and the ``(total + 1) // 2`` threshold are its.

All comparisons run on sortable keys biased into signed order
(utils/dtypes.py), so duplicates, -0.0/+0.0 and the full integer range
behave exactly. The loop's exit reads the reduced hit test, the same on
every rank, so every rank runs the same rounds.
"""

from __future__ import annotations

import math

import torch

from mpi_k_selection_tpu_torch.parallel import mesh as mesh_lib
from mpi_k_selection_tpu_torch.utils import debug as _debug, dtypes as _dt


def default_max_rounds(n: int) -> int:
    """True-median pivots discard >= 1/4 of the live set a round; the
    slack covers duplicate-heavy ties and the integer range."""
    return 64 + 8 * int(math.ceil(math.log2(n + 1)))


def distributed_cgm_select(x, k, *, mesh=None, max_rounds: int | None = None, return_rounds: bool = False):
    """Exact k-th smallest (1-indexed) of the global ``x`` over ``mesh``
    by CGM weighted-median rounds; every rank calls it with the same ``x``
    (or its own :class:`~mpi_k_selection_tpu_torch.parallel.mesh.Shard`)
    and gets the answer, a 0-d tensor on its device (and the round count,
    an int, if ``return_rounds``)."""
    mesh = mesh_lib.make_mesh() if mesh is None else mesh
    mesh_lib.require_distributed(mesh)
    n = mesh_lib.global_size(x)
    _debug.check_concrete_k(k, n)
    shard = mesh_lib.shard_1d(x, mesh).block
    bits = _dt.key_bits(shard.dtype)
    s = torch.sort(_dt.order_bias(_dt.to_sortable_bits(shard), bits)).values  # local pre-sort (TODO-…:115)
    m = s.numel()
    if max_rounds is None:
        max_rounds = default_max_rounds(n)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int64, device=mesh.device)

    lo, hi = scalar(0), scalar(m)
    kk = torch.as_tensor(k, dtype=torch.int64, device=mesh.device).reshape(()).clamp(1, n)
    ans = s[0].to(torch.int64)
    found, rounds = False, 0
    while not found and rounds < max_rounds:
        w = hi - lo
        med = s[((lo + hi) // 2).clamp(0, m - 1)].to(torch.int64)  # exact local median of the window
        pairs = mesh.all_gather(torch.stack([med, w]))  # (P, 2): the :135-136 gathers, fused
        meds, ws = pairs[:, 0], pairs[:, 1]
        # the weighted median, on every rank (:139-165 + :168)
        order = torch.argsort(meds, stable=True)
        cumw = torch.cumsum(ws[order], 0)
        idx = (cumw >= (cumw[-1] + 1) // 2).to(torch.int32).argmax()
        pivot = meds[order][idx]
        # local L/E/G by two binary searches (the :175-185 sweep)
        pv = pivot.to(s.dtype).reshape(1)
        lb = torch.searchsorted(s, pv, side="left")[0].clamp(lo, hi)
        rb = torch.searchsorted(s, pv, side="right")[0].clamp(lo, hi)
        leg = mesh.all_reduce(torch.stack([lb - lo, rb - lb, hi - rb]))  # the one Allreduce (:190)
        less, eq = leg[0], leg[1]
        hit = (less < kk) & (kk <= less + eq)  # exact test (:194)
        go_low = kk <= less  # discard >= pivot (:204-213)
        keep_lo = hit | go_low
        lo, hi = torch.where(keep_lo, lo, rb), torch.where(hit, hi, torch.where(go_low, lb, hi))
        kk = torch.where(keep_lo, kk, kk - (less + eq))  # k shift (:224)
        ans = torch.where(hit, pivot, ans)
        rounds += 1
        found = bool(hit)  # a reduced value: every rank reads the same
    if not found:
        raise RuntimeError(
            f"CGM selection did not converge within {max_rounds} rounds — "
            "this indicates a bug (the exact-hit test is guaranteed to fire); "
            "please report with the input configuration"
        )
    value = _dt.from_sortable_bits(_dt.order_bias(ans.to(s.dtype), bits), shard.dtype).reshape(())
    if return_rounds:
        return value, rounds
    return value
