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
  the values from the batched top-k kernel (``csrc/topk.cu``), exact by
  construction, then the indices by the streaming recovery
  (:func:`_block_topk_indices`): one pass of per-(row, 128-block) counts
  beyond and equal to the row's k-th key, rank searches over the blocks,
  a gather of the <= k blocks per row that hold winners, and a bounded
  rescue of the rows it cannot resolve.

Indices are int64, torch's index dtype.
"""

from __future__ import annotations

import torch

from mpi_k_selection_tpu_torch.api import as_selection_array
from mpi_k_selection_tpu_torch.ops.cuda.histogram import ROW, tau_counts
from mpi_k_selection_tpu_torch.ops.cuda.topk import batched_topk_supported, batched_topk_values
from mpi_k_selection_tpu_torch.ops.radix import _Descent, _select_key_on_prep, row_cumsum
from mpi_k_selection_tpu_torch.utils import dtypes as _dt

METHODS = ("auto", "threshold", "tournament", "chunked", "flat", "block")
RESCUE_ROWS = 64  # rows the block recovery re-solves one by one; more take a full sort


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
    if torch.device(device).type == "cuda" and largest and batched_topk_supported(shape, dtype, k):
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
    x = as_selection_array(x, device)
    if x.dim() == 0:
        raise ValueError("topk needs at least one axis")
    d = x.shape[-1]
    if not 1 <= k <= d:
        raise ValueError(f"k={k} out of range for last axis of size {d}")
    method = resolve_topk_method(method, tuple(x.shape), k, x.dtype, x.device, largest)
    if method == "block":
        if x.dim() != 2 or not largest:
            raise ValueError("block method applies to 2-D inputs, largest=True")
        x = x.contiguous()
        values = batched_topk_values(x, k)
        return values, _block_topk_indices(x, values, k)
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


def _block_topk_indices_from_values(x: torch.Tensor, values: torch.Tensor, k: int):
    """Per-row indices pairing the block kernel's sorted ``values`` (B, k)
    with their positions in ``x`` (B, D): ``(idx (B, k) int64, ok (B,)
    bool)``.

    With the row's k-th key ``tau`` known, one pass over ``x`` gives the
    per-(row, 128-block) counts of keys beyond and equal to tau; running
    sums over the ``D / 128`` blocks route output slot j to its block (strict
    winners fill the slots ``j < g``, ties of tau the rest, each by
    position) and to its rank within that block; one ``(B, k, 128)``
    gather of raw blocks finds each slot's element. All comparisons are in
    key space (``-0.0 < +0.0``). The slots are then ordered by (key
    descending, position ascending), ``lax.top_k``'s rule, by pairwise
    ranks and a scatter over the k axis.

    ``ok`` requires every slot found, no NaN among ``values`` and a strict
    count g <= k-1, the JAX package's guards; rows failing them take the
    caller's rescue. Peak memory is about two (B, D) key tensors: the key
    transform and its comparisons are separate passes here."""
    b, d = x.shape
    nb = d // ROW
    bits = _dt.key_bits(x.dtype)
    dev = x.device
    tb = _dt.order_bias(_dt.to_sortable_bits(values[:, k - 1]), bits)[:, None, None]
    kb = _dt.order_bias(_dt.to_sortable_bits(x.reshape(b, nb, ROW)), bits)
    ogt = row_cumsum((kb > tb).sum(2, dtype=torch.int32))  # (B, nb) running counts
    oeq = row_cumsum((kb == tb).sum(2, dtype=torch.int32))
    del kb
    g = ogt[:, -1:]  # strict winners; <= k-1 for an exact tau
    j = torch.arange(k, device=dev)
    strict = j < g  # (B, k): slot j takes a strict winner, else a tie of tau
    target = torch.where(strict, j + 1, j - g + 1)  # 1-based rank sought
    blk = torch.where(strict, torch.searchsorted(ogt, target), torch.searchsorted(oeq, target))
    blk = blk.clamp_(0, nb - 1)
    bm1 = (blk - 1).clamp(min=0)
    prev = torch.where(blk > 0, torch.where(strict, ogt.gather(1, bm1), oeq.gather(1, bm1)), 0)
    r = target - prev  # 1-based rank within the block (<= k)
    raw = _dt.bit_view(x).reshape(b, nb, ROW).gather(1, blk[..., None].expand(b, k, ROW))
    ub = _dt.order_bias(_dt.to_sortable_bits(raw.view(x.dtype)), bits)  # (B, k, 128)
    m = torch.where(strict[..., None], ub > tb, ub == tb)
    hit = m & (torch.cumsum(m, 2) == r[..., None])  # one-hot along the block, or empty
    found = hit.any(2)
    local = hit.to(torch.int32).argmax(2)  # the first hit, 0 when none
    idx = blk * ROW + local  # strict winners, then ties, each by position
    # each slot's key, the minimum (unsigned 0) where nothing was found
    least = torch.iinfo(ub.dtype).min if bits >= 32 else 0
    wk = torch.where(found, ub.gather(2, local[..., None])[..., 0], least)
    wi, wj = wk[:, :, None], wk[:, None, :]
    ti = j[:, None]
    beats = (wj > wi) | ((wj == wi) & (ti > j))  # [b, i, j]: slot j outranks slot i
    rank = beats.sum(2)  # a permutation of 0..k-1 per row
    idx = torch.empty_like(idx).scatter_(1, rank, idx)
    # the JAX package's guards, kept so ``ok`` equals its: on this kernel's
    # values (the input's own bits) only the NaN guard can fire
    ok = found.all(1) & ~torch.isnan(values).any(1) & (g[:, 0] <= k - 1)
    return idx, ok


def _block_topk_indices(x: torch.Tensor, values: torch.Tensor, k: int) -> torch.Tensor:
    """Index half of ``method="block"``: :func:`_block_topk_indices_from_values`,
    then the rows it could not resolve re-solved exactly by a stable sort
    of their signed keys. One host read of the bad-row count decides: no
    row, up to :data:`RESCUE_ROWS` gathered rows, or every row (the JAX
    package's ``lax.cond`` full fallback)."""
    idx, ok = _block_topk_indices_from_values(x, values, k)
    bad = ~ok
    nbad = int(bad.sum())
    if nbad == 0:
        return idx
    if nbad > RESCUE_ROWS:
        return _sorted_topk(_signed_keys(x, True), k)[1]
    rows = bad.nonzero()[:, 0]
    idx[rows] = _sorted_topk(_signed_keys(x[rows], True), k)[1]
    return idx


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
