"""Top-k selection, values and indices (counterpart of
``mpi_k_selection_tpu/ops/topk.py``).

The order is the sortable keys' (utils/dtypes.py), a total order: the k
largest come in descending key order and the k smallest in ascending, and
equal keys go by ascending position. So ``-0.0`` ranks below ``+0.0``,
``+nan`` above ``+inf`` and ``-nan`` below ``-inf``, as ``lax.top_k`` and
the JAX package's threshold path order them. ``torch.topk`` orders NaNs
and ties otherwise, so no method here calls it; ``flat``, ``chunked`` and
``tournament`` sort signed keys with a stable descending ``torch.sort``.

Methods:

- ``threshold`` (1-D): the k-th extreme key ``tau`` by the radix descent
  (ops/radix.py), then the winners from one read of per-row ``(beyond,
  equal)`` counts (the ``tau_counts`` kernel), a rank search over the
  rows and a gather of just the rows that hold winners. No sort of the
  input. The descent and the collect share one
  :class:`~mpi_k_selection_tpu_torch.ops.radix._Descent`.
- ``tournament`` (1-D): rounds of per-row top-k over ``(rows, sub)``
  reshapes shrink the candidate pool until one small top-k finishes.
- ``chunked``: a top-k per chunk of the last axis, then a top-k of the
  candidates.
- ``flat``: one top-k over the last axis.
- ``block`` (2-D ``(B, D)``, largest only, inside
  :func:`~mpi_k_selection_tpu_torch.ops.cuda.topk.batched_topk_supported`):
  values and positions from one launch of the batched top-k kernel
  (``csrc/topk.cu``), exact by construction, ties by position. The JAX
  package recovers the positions after its values kernel, with an ``ok``
  flag per row and a rescue of the rows it cannot resolve; here nothing
  is recovered or rescued, so no such flag exists.

Indices are int64, torch's index dtype. A call of :func:`topk` is one
``ksel.topk`` span (utils/profiling.py:``span``).
"""

from __future__ import annotations

import torch

from mpi_k_selection_tpu_torch import api as _api  # a module: api imports ops, which exports this module
from mpi_k_selection_tpu_torch.ops.cuda import topk as _block
from mpi_k_selection_tpu_torch.ops.cuda.histogram import ROW, tau_counts
from mpi_k_selection_tpu_torch.ops.radix import _Descent, _select_key_on_prep, row_cumsum
from mpi_k_selection_tpu_torch.utils import dtypes as _dt
from mpi_k_selection_tpu_torch.utils.profiling import span

METHODS = ("auto", "threshold", "tournament", "chunked", "flat", "block")


def _signed_keys(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """Keys whose DESCENDING signed order is the requested order of ``x``:
    the sortable keys (``~`` of them for the smallest), biased into signed
    order. Always the key transform, never ``x`` itself: a native float
    compare would not rank ``-0.0`` below ``+0.0`` or order the NaNs."""
    u = _dt.to_sortable_bits(x)
    if not largest:
        u = ~u
    return _dt.order_bias(u, _dt.key_bits(x.dtype))


def _decode_keys(kv: torch.Tensor, dtype, largest: bool) -> torch.Tensor:
    """Inverse of :func:`_signed_keys`: signed keys back to values of
    ``dtype``, bit for bit."""
    u = _dt.order_bias(kv, _dt.key_bits(dtype))
    if not largest:
        u = ~u
    return _dt.from_sortable_bits(u, dtype)


def _sorted_topk(keys: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest signed keys along the last
    axis, ties by ascending position (a stable descending sort)."""
    s = torch.sort(keys, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def resolve_topk_method(method: str, shape, k: int, dtype=torch.float32, device="cpu", largest: bool = True) -> str:
    """The method ``auto`` takes: ``block`` for a CUDA tensor that is 2-D,
    ``largest`` and inside the batched kernel's envelope (the JAX
    package's dispatch on its accelerator); otherwise its dispatch for
    other devices (threshold for a large 1-D input, chunked for a long
    last axis, else flat), with its thresholds, not yet measured on a CUDA
    card. An explicit method is checked and kept."""
    if method not in METHODS:
        raise ValueError(f"unknown topk method {method!r}; choose from {METHODS}")
    if method != "auto":
        return method
    if torch.device(device).type == "cuda" and largest and _block.batched_topk_supported(shape, dtype, k):
        return "block"
    d = shape[-1]
    if len(shape) == 1 and d >= 1 << 18 and d >= 64 * k and d < 2**31:
        return "threshold"
    if d >= 1 << 16 and d >= 64 * k:
        return "chunked"
    return "flat"


def topk(x, k: int, *, largest: bool = True, method: str = "auto", num_chunks: int | None = None, device=None):
    """Top-k along the last axis: ``(values, indices)``, sorted by rank
    (descending for ``largest``, else ascending; ties by ascending
    position). Leading axes batch, except for the 1-D-only ``threshold``
    and ``tournament`` methods. Runs on ``x``'s device (a non-tensor input
    goes to ``device``, default ``"cuda"``)."""
    with span("ksel.topk"):
        x = _api.as_selection_array(x, device)
        if x.dim() == 0:
            raise ValueError("topk needs at least one axis")
        d = x.shape[-1]
        if not 1 <= k <= d:
            raise ValueError(f"k={k} out of range for last axis of size {d}")
        method = resolve_topk_method(method, tuple(x.shape), k, x.dtype, x.device, largest)
        if method == "block":
            if x.dim() != 2 or not largest:
                raise ValueError("block method applies to 2-D inputs, largest=True")
            return _block.batched_topk(x.contiguous(), k)
        if method in ("threshold", "tournament"):
            if x.dim() != 1:
                raise ValueError(f"{method} method applies to 1-D inputs")
            if method == "threshold":
                idx = _threshold_topk_indices(x, k, largest)
            else:
                idx = _tournament_topk_indices(_signed_keys(x, largest), k)
            # through the signed view: CUDA has no index kernel for uint16/32/64
            return _dt.bit_view(x)[idx].view(x.dtype), idx
        keys = _signed_keys(x, largest)
        c = 1 if method == "flat" else (num_chunks or _pick_num_chunks(d, k))
        if c <= 1 or d % c:
            kv, idx = _sorted_topk(keys, k)
        else:
            sub = d // c
            subvals, subidx = _sorted_topk(keys.reshape(*keys.shape[:-1], c, sub), min(k, sub))
            base = torch.arange(c, device=x.device)[:, None] * sub
            cand_idx = (subidx + base).reshape(*keys.shape[:-1], -1)
            kv, pos = _sorted_topk(subvals.reshape(*keys.shape[:-1], -1), k)
            idx = cand_idx.gather(-1, pos)
        return _decode_keys(kv, x.dtype, largest), idx


def _threshold_topk_indices(x: torch.Tensor, k: int, largest: bool) -> torch.Tensor:
    """Indices of the k extreme elements of 1-D ``x``: the threshold key
    by the radix descent, then the winner collect on the same prepared
    words. Exact under duplicates: every strict winner, then the
    earliest-position ties of the threshold."""
    n = x.numel()
    prep = _Descent(x)  # ksel: noqa[KSL003] -- no f64 approximation exists in the port (native f64 bitcasts)
    # k-th largest == (n-k+1)-th smallest
    tauk = _select_key_on_prep(prep, n - k + 1 if largest else k)
    return _threshold_indices_via_counts(prep, tauk, k, largest)


def _threshold_indices_via_counts(prep: _Descent, tauk: torch.Tensor, k: int, largest: bool) -> torch.Tensor:
    """The winner collect: one read of per-128-element-row counts of keys
    strictly beyond ``tauk`` and equal to it (:func:`tau_counts`), rank
    searches that route winner slot j to its row (strict winners fill
    slots ``j < g``, ties of tau the rest), one ``(k, 128)`` row gather and
    a running rank within the row. Since tau is the exact k-th key, g <=
    k-1 and the ties hold the rest: every slot resolves. The winners are
    then ordered by key, ties by position."""
    n = prep.n
    cnt = tau_counts(prep.words, tau=tauk, largest=largest, key_op=prep.key_op, key_xor=prep.key_xor)
    rows = cnt.shape[1]
    off = row_cumsum(cnt)  # (2, R): beyond, equal
    g = off[0, -1]
    jj = torch.arange(k, device=off.device)
    strict = jj < g
    target = torch.where(strict, jj + 1, jj - g + 1)  # 1-based rank sought
    b = torch.where(
        strict, torch.searchsorted(off[0], target), torch.searchsorted(off[1], target)
    ).clamp_(max=rows - 1)
    bm1 = (b - 1).clamp(min=0)
    prev = torch.where(b > 0, torch.where(strict, off[0][bm1], off[1][bm1]), 0)
    r = target - prev  # 1-based rank within row b
    pos = b[:, None] * ROW + torch.arange(ROW, device=off.device)  # (k, ROW)
    keys = prep.key_of(prep.words[pos.clamp(max=n - 1)])
    kb, tb = _dt.order_bias(keys, prep.total_bits), _dt.order_bias(tauk, prep.total_bits)
    beyond = kb > tb if largest else kb < tb
    m = torch.where(strict[:, None], beyond, keys == tauk) & (pos < n)
    within = torch.cumsum(m, 1)
    local = ((within == r[:, None]) & m).to(torch.int32).argmax(1)
    idx = b * ROW + local
    wkey = kb.gather(1, local[:, None])[:, 0]
    order = torch.sort(wkey, descending=largest, stable=True).indices
    return idx[order]


def _tournament_topk_indices(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest signed keys of 1-D ``keys`` by reduction
    rounds: each round keeps every row's top-k of a ``(rows, sub)`` view,
    which holds the global top-k. The pool keeps equal keys in position
    order, so ties still go by position."""
    d = keys.shape[0]
    sub = 1024
    while sub < 4 * k:  # rows must be enough larger than k to shrink the pool
        sub *= 2
    idx = None
    finish = max(1 << 16, sub)
    while d > finish:
        rows = d // sub
        main = rows * sub
        vals, sidx = _sorted_topk(keys[:main].reshape(rows, sub), k)
        cand = (sidx + torch.arange(rows, device=keys.device)[:, None] * sub).reshape(-1)
        vals = vals.reshape(-1)
        if main < d:  # the ragged tail rides along as extra candidates
            cand = torch.cat([cand, torch.arange(main, d, device=keys.device)])
            vals = torch.cat([vals, keys[main:]])
        idx = cand if idx is None else idx[cand]
        keys = vals
        d = keys.shape[0]
    _, pos = _sorted_topk(keys, k)
    return pos if idx is None else idx[pos]


def _pick_num_chunks(d: int, k: int) -> int:
    """Largest power-of-two chunk count with chunk size >= max(256, 2k)."""
    c = 1
    while d % (c * 2) == 0 and d // (c * 2) >= max(256, 2 * k):
        c *= 2
    return c


def batched_topk(x, k: int, **kwargs):
    """:func:`topk` on ``(..., D)`` inputs (the BASELINE batched shape)."""
    return topk(x, k, **kwargs)
