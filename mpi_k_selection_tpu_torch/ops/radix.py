"""Exact k-selection by radix descent (PyTorch).

Counterpart of ``mpi_k_selection_tpu/ops/radix.py``. Each pass counts digit
occurrences among the elements that still match the current bit prefix,
narrows the prefix by ``radix_bits`` bits, and rebases k; after
``key_bits / radix_bits`` passes the answer's bits are fully determined.
Counts are exact integers, so the answer is always the true k-th smallest
(1-indexed, duplicates included).

The cutover (the production fast path): after ``ncut`` passes, if the
surviving population fits ``cutover_budget``, collect those survivors and
sort them instead of running the remaining passes; otherwise run one more
pass and try again; only then finish the fixed schedule
(:func:`run_cutover_ladder`).

Many ranks (:func:`radix_select_many`, the p50/p90/p99 telemetry shape):
the prefix-free first pass is one histogram shared by every query, and
each later pass runs all K queries through one read of the data
(:func:`~mpi_k_selection_tpu_torch.ops.histogram.multi_masked_radix_histogram`),
so the data is read ``npasses`` times in all instead of ``1 + K *
(npasses - 1)``. The cutover applies to the whole batch: one test of the
LARGEST query population, then one K-wide collect and sort.

Device discipline: ``prefix``, ``kk`` and every count stay on the device,
and the histogram kernel reads the prefix through a device pointer, so
the passes before the cutover queue without a host sync. Each rung of the
ladder reads one population to the host (the JAX package's ``lax.cond``).
"""

from __future__ import annotations

import torch

from mpi_k_selection_tpu_torch.ops.cuda.histogram import NARROW_BITS, ROW, match_counts
from mpi_k_selection_tpu_torch.ops.histogram import (
    masked_radix_histogram,
    multi_masked_radix_histogram,
    prepare_raw,
)
from mpi_k_selection_tpu_torch.utils import dtypes as _dt


def default_radix_bits() -> int:
    """4 for every dtype and device: 4-bit digits keep the pass schedule of
    the JAX package's kernel path, and the plain method, the kernels' CPU
    stand-in, walks the same schedule as the card."""
    return 4


def cutover_passes(n: int, total_bits: int, radix_bits: int, budget: int) -> int | None:
    """Number of full histogram passes to run before the first
    collect-and-sort attempt, or None when the fixed schedule is better.

    Chosen so the expected surviving population (``n >> resolved_bits`` for
    full-range uniform keys) is <= budget/16, the JAX package's rule
    (ops/radix.py:cutover_passes there); data denser than the model falls
    to the next rung of the ladder."""
    if n < (1 << 20):  # small inputs: pass cost is trivial, skip the cutover
        return None
    npasses = total_bits // radix_bits
    r = radix_bits
    while r < total_bits and (n >> r) > max(budget >> 4, 64):
        r += radix_bits
    ncut = r // radix_bits
    if ncut >= npasses:
        return None
    if (npasses - ncut - 1) * n <= 100_000_000:  # collect ~ 1 pass
        return None
    return ncut


def resolve_cutover(cutover, n, total_bits, radix_bits, budget):
    """Cutover pass count: ``"auto"`` -> :func:`cutover_passes`, None ->
    disabled, int -> forced (validated against the pass count)."""
    npasses = total_bits // radix_bits
    if cutover == "auto":
        return cutover_passes(n, total_bits, radix_bits, budget)
    if cutover is None:
        return None
    ncut = int(cutover)
    if not 1 <= ncut < npasses:
        raise ValueError(f"cutover={ncut} out of range [1, {npasses - 1}]")
    return ncut


def run_cutover_ladder(ncut, npasses, pop0, pred, step, finish_small, finish_full_from, state):
    """The 2-rung cutover ladder: try the collect after ``ncut`` passes; if
    the surviving population overflows, run ONE more pass and try again;
    only then run the remaining fixed passes.

    ``pred(pop)`` is the fits-the-budget test (a host read of ``pop``);
    ``step(p, state) -> (state, pop)`` runs pass p;
    ``finish_small(resolved_passes)`` / ``finish_full_from(p0)`` return the
    functions that finish from ``state``."""
    if pred(pop0):
        return finish_small(ncut)(state)
    if ncut + 1 < npasses:
        state, pop = step(ncut, state)
        if pred(pop):
            return finish_small(ncut + 1)(state)
        return finish_full_from(ncut + 1)(state)
    return finish_full_from(ncut)(state)


def bucket_walk_step(hist, kk, prefix, kdt, radix_bits):
    """One descent step on a bucket histogram: pick the bucket holding the
    k-th element, rebase k within it, extend the prefix. ``prefix=None`` on
    the first (prefix-free) step. All on the device; returns
    ``(prefix, kk, bucket_count)``, each of shape (1,)."""
    cum = torch.cumsum(hist, 0)
    bucket = (cum >= kk).to(torch.int32).argmax().reshape(1)
    count = hist.gather(0, bucket)
    kk = kk - (cum.gather(0, bucket) - count)
    bkey = bucket.to(kdt)
    if prefix is not None:
        bkey = (prefix << radix_bits) | bkey
    return bkey, kk, count


def bucket_walk_step_multi(hist2d, kk, prefixes, kdt, radix_bits):
    """:func:`bucket_walk_step` for K queries at once: ``hist2d`` is (K,
    nbuckets), each query's histogram from one shared read, and ``kk`` /
    ``prefixes`` are (K,). ``prefixes=None`` on the shared prefix-free
    first step, where ``hist2d`` may be one (nbuckets,) histogram that
    serves every query. Returns ``(prefixes, kk, bucket_counts)``, each
    (K,)."""
    if hist2d.dim() == 1:
        hist2d = hist2d.expand(kk.shape[0], -1)
    cum = torch.cumsum(hist2d, 1)
    bucket = (cum >= kk[:, None]).to(torch.int32).argmax(1, keepdim=True)
    count = hist2d.gather(1, bucket)[:, 0]
    kk = kk - (cum.gather(1, bucket)[:, 0] - count)
    bkey = bucket[:, 0].to(kdt)
    if prefixes is not None:
        bkey = (prefixes << radix_bits) | bkey
    return bkey, kk, count


class _Descent:
    """Per-select state: the words the kernels read (the raw input when its
    dtype folds into the kernels, else its widened keys), the key
    transform, and the one-pass bucket walk."""

    def __init__(self, x: torch.Tensor, radix_bits=None, *, reduce=None, gather=None, n_total=None):
        if radix_bits is None:
            radix_bits = default_radix_bits()
        total_bits = _dt.key_bits(x.dtype)
        if radix_bits < 1 or total_bits % radix_bits:
            raise ValueError(f"radix_bits={radix_bits} must divide key bits {total_bits}")
        self.radix_bits = radix_bits
        self.total_bits = total_bits
        self.npasses = total_bits // radix_bits
        self.kdt = _dt.key_dtype(x.dtype)
        self.n = x.numel()
        # the distributed hooks (parallel/radix.py): ``reduce`` sums each
        # pass's histogram over the ranks, ``gather`` concatenates the
        # collect's (K, budget) candidates along axis 1, and ``n_total`` is
        # the count the ranks range over; one device keeps the identity
        self.reduce = _same if reduce is None else reduce
        self.gather = _same if gather is None else gather
        self.n_total = self.n if n_total is None else n_total
        raw = prepare_raw(x)
        if raw is not None:
            self.words, self.key_op, self.key_xor = raw
        else:
            # sub-32-bit keys, widened to non-negative int32 words: a key's
            # top r bits are its word's top r + word_bits - total_bits bits
            self.words = _dt.to_sortable_bits(x.reshape(-1))
            self.key_op, self.key_xor = "none", 0
        self.word_bits = self.words.element_size() * 8
        # the prefix of the first pass: none (every key), except for a digit
        # wider than the histogram kernel's under widened keys, which counts
        # under a prefix: their words' bits above the key are zero
        self.top_prefix = None
        if radix_bits > NARROW_BITS and self.word_bits > total_bits:
            self.top_prefix = torch.zeros(1, dtype=self.words.dtype, device=self.words.device)

    def key_of(self, words: torch.Tensor) -> torch.Tensor:
        return _dt.keys_from_raw(words, self.key_op, self.key_xor)

    def one_pass(self, p, prefix, kk):
        shift = self.total_bits - (p + 1) * self.radix_bits
        hist = masked_radix_histogram(
            self.words,
            shift=shift,
            radix_bits=self.radix_bits,
            prefix=prefix if p else self.top_prefix,
            key_op=self.key_op,
            key_xor=self.key_xor,
        )
        return bucket_walk_step(self.reduce(hist), kk, prefix if p else None, self.kdt, self.radix_bits)

    def multi_pass(self, p, prefixes, kk):
        """Pass ``p >= 1`` for K queries: one read, K histograms."""
        hist = multi_masked_radix_histogram(
            self.words,
            shift=self.total_bits - (p + 1) * self.radix_bits,
            radix_bits=self.radix_bits,
            prefixes=prefixes,
            key_op=self.key_op,
            key_xor=self.key_xor,
        )
        return bucket_walk_step_multi(self.reduce(hist), kk, prefixes, self.kdt, self.radix_bits)

    def first_multi_pass(self, kk):
        """The prefix-free pass shared by K queries: one histogram serves
        every query."""
        hist = masked_radix_histogram(
            self.words, shift=self.total_bits - self.radix_bits, radix_bits=self.radix_bits,
            prefix=self.top_prefix, key_op=self.key_op, key_xor=self.key_xor,
        )
        return bucket_walk_step_multi(self.reduce(hist), kk, None, self.kdt, self.radix_bits)


def _same(t):
    return t


def row_cumsum(cnt: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 running sums along each row of (K, R) counts, from
    ONE scan of the flattened counts minus each row's start: on CUDA a
    scan along the last axis of a few long rows runs one block per row
    (15.4 of the 31.7 ms of a K=4 quantiles of 2^30 int32 on an H100 80GB
    HBM3, 700 W, before this form), while a 1-D scan spans the card."""
    flat = torch.cumsum(cnt.reshape(-1), 0, dtype=torch.int64).view(cnt.shape)
    return flat - torch.nn.functional.pad(flat[:-1, -1], (1, 0))[:, None]


def _gather_candidates(prep: _Descent, cnt, resolved_bits: int, prefixes, budget: int):
    """Up to ``budget`` matching keys per prefix, from per-row match counts
    ``cnt`` (K, R): each candidate slot finds its row by a search over the
    running counts, gathers that whole 128-element row, and takes its
    match of the right rank. Returns ``(values (K, budget) in key space,
    padded with the order-maximum, pops (K,))``."""
    n, dev = prep.n, cnt.device
    nq, rows = cnt.shape
    off = row_cumsum(cnt)
    pops = off[:, -1]
    target = torch.arange(1, budget + 1, device=dev).expand(nq, budget).contiguous()
    b = torch.searchsorted(off, target).clamp_(max=rows - 1)
    prev = torch.where(b > 0, off.gather(1, (b - 1).clamp(min=0)), 0)
    rank = target - prev  # 1-based rank within row b
    pos = b[..., None] * ROW + torch.arange(ROW, device=dev)  # (K, budget, ROW)
    keys = prep.key_of(prep.words[pos.clamp(max=n - 1)])
    carrier_bits = keys.element_size() * 8
    top = _dt.shift_right_logical(keys, prep.total_bits - resolved_bits, carrier_bits)
    rmatch = (top == prefixes[:, None, None]) & (pos < n)
    within = torch.cumsum(rmatch, 2)
    local = ((within == rank[..., None]) & rmatch).to(torch.int32).argmax(2)
    vals = keys.gather(2, local[..., None])[..., 0]
    vals = torch.where(target <= pops[:, None], vals, _dt.max_key(prep.total_bits))
    return vals, pops


def _collect_via_counts(prep: _Descent, resolved_passes: int, prefixes, budget: int):
    """Collect up to ``budget`` candidates per prefix through the
    match-count kernel: one streaming read counts every prefix's matches
    per 128-element row, then each candidate slot gathers just its row.
    ``prefixes`` is (K,) in key space. The kernel reads whole 32/64-bit
    words, so any resolved width works (the JAX package's kernel reads the
    hi plane of 64-bit keys and needs ``resolved_bits <= 32``), and
    sub-32-bit keys count on their widened words (the JAX package's
    ``_collect_prefix_matches{,_multi}``, whose K-wide match mask would be
    a (K, n) tensor)."""
    res = resolved_passes * prep.radix_bits
    cnt = match_counts(
        prep.words, resolved_bits=res + prep.word_bits - prep.total_bits, prefixes=prefixes,
        key_op=prep.key_op, key_xor=prep.key_xor,
    )
    return _gather_candidates(prep, cnt, res, prefixes, budget)


def _sorted_pick(prep: _Descent, cand, kk):
    """The ``kk``-th smallest (1-based, (K,)) of each row of ``cand`` (K,
    C), in key order."""
    s = _dt.order_bias(torch.sort(_dt.order_bias(cand, prep.total_bits), dim=1).values, prep.total_bits)
    return s.gather(1, (kk - 1).clamp(0, cand.shape[1] - 1)[:, None])[:, 0]


def _collect_and_pick(prep: _Descent, resolved_passes: int, prefixes, kk, budget: int):
    """The collect rung: up to ``budget`` candidates per prefix (from every
    rank, through ``prep.gather``), then each query's pick."""
    cand, _ = _collect_via_counts(prep, resolved_passes, prefixes, budget)
    return _sorted_pick(prep, prep.gather(cand), kk)


def _select_key_on_prep(prep: _Descent, k, *, cutover="auto", cutover_budget: int = 8192):
    """The radix descent on a prebuilt :class:`_Descent`, returning the
    answer in key space, shape (1,)."""
    n, rb, npasses, kdt = prep.n_total, prep.radix_bits, prep.npasses, prep.kdt
    dev = prep.words.device
    kk = torch.as_tensor(k, dtype=torch.int64, device=dev).reshape(1).clamp(1, n)
    prefix = torch.zeros(1, dtype=kdt, device=dev)
    ncut = resolve_cutover(cutover, n, prep.total_bits, rb, cutover_budget)
    if ncut is None:
        for p in range(npasses):
            prefix, kk, _ = prep.one_pass(p, prefix, kk)
        return prefix

    pop = None
    for p in range(ncut):
        prefix, kk, pop = prep.one_pass(p, prefix, kk)

    def finish_small(resolved_passes):
        def fn(state):
            return _collect_and_pick(prep, resolved_passes, *state, cutover_budget)

        return fn

    def finish_full_from(p0):
        def fn(state):
            prefix, kk = state
            for p in range(p0, npasses):
                prefix, kk, _ = prep.one_pass(p, prefix, kk)
            return prefix

        return fn

    def step(p, state):
        prefix, kk, pop = prep.one_pass(p, *state)
        return (prefix, kk), pop

    return run_cutover_ladder(
        ncut, npasses, pop, lambda q: int(q) <= cutover_budget, step,
        finish_small, finish_full_from, (prefix, kk),
    )


def radix_select(
    x: torch.Tensor,
    k,
    *,
    radix_bits: int | None = None,
    cutover: int | str | None = "auto",
    cutover_budget: int = 8192,
) -> torch.Tensor:
    """Exact k-th smallest element of ``x`` (k is 1-indexed; a tensor k is
    clamped to [1, n]) as a 0-d tensor of ``x``'s dtype on its device.

    ``cutover``: ``"auto"`` resolves via :func:`cutover_passes`; an int
    forces that pass count; None runs the fixed schedule."""
    if cutover_budget < 1:
        raise ValueError(f"cutover_budget={cutover_budget} must be >= 1")
    x = x.reshape(-1)
    # CUDA float64 bitcasts are exact, so the port has no f64 approximation
    # to warn about: the reference's f64 shells have no counterpart here
    prep = _Descent(x, radix_bits)  # ksel: noqa[KSL003] -- no f64 approximation exists in the port (native f64 bitcasts)
    ans = _select_key_on_prep(prep, k, cutover=cutover, cutover_budget=cutover_budget)
    return _dt.from_sortable_bits(ans, x.dtype).reshape(())


def _select_many_on_prep(prep: _Descent, kk, *, cutover="auto", cutover_budget: int = 8192):
    """The shared multi-rank walk on a prebuilt :class:`_Descent` for the
    (K,) int64 ranks ``kk`` (in [1, n]), returning the answers in key
    space, shape (K,)."""
    rb, npasses = prep.radix_bits, prep.npasses
    prefixes, kk, pops = prep.first_multi_pass(kk)
    ncut = resolve_cutover(cutover, prep.n_total, prep.total_bits, rb, cutover_budget)
    if ncut is None:
        for p in range(1, npasses):
            prefixes, kk, _ = prep.multi_pass(p, prefixes, kk)
        return prefixes
    for p in range(1, ncut):
        prefixes, kk, pops = prep.multi_pass(p, prefixes, kk)

    def finish_small(resolved_passes):
        def fn(state):
            return _collect_and_pick(prep, resolved_passes, *state, cutover_budget)

        return fn

    def finish_full_from(p0):
        def fn(state):
            prefixes, kk = state
            for p in range(p0, npasses):
                prefixes, kk, _ = prep.multi_pass(p, prefixes, kk)
            return prefixes

        return fn

    def step(p, state):
        prefixes, kk, pops = prep.multi_pass(p, *state)
        return (prefixes, kk), pops

    return run_cutover_ladder(
        ncut, npasses, pops, lambda q: int(q.max()) <= cutover_budget, step,
        finish_small, finish_full_from, (prefixes, kk),
    )


def radix_select_many(
    x: torch.Tensor,
    ks,
    *,
    radix_bits: int | None = None,
    cutover: int | str | None = "auto",
    cutover_budget: int = 8192,
) -> torch.Tensor:
    """Exact k-th smallest of ``x`` for EVERY k in ``ks`` (1-indexed; a
    tensor of ks is clamped to [1, n]), in ``ks`` order: a tensor of
    ``x``'s dtype on its device, of shape ``ks.shape`` with a scalar k read
    as one query (shape (1,)). Options as in :func:`radix_select`."""
    if cutover_budget < 1:
        raise ValueError(f"cutover_budget={cutover_budget} must be >= 1")
    x = x.reshape(-1)
    dev = x.device
    ks_t = torch.as_tensor(ks, dtype=torch.int64, device=dev)
    shape = ks_t.shape if ks_t.dim() else (1,)
    prep = _Descent(x, radix_bits)  # ksel: noqa[KSL003] -- no f64 approximation exists in the port (native f64 bitcasts)
    kk = ks_t.reshape(-1).clamp(1, prep.n)
    if kk.numel() == 0:
        return torch.empty(shape, dtype=x.dtype, device=dev)
    ans = _select_many_on_prep(prep, kk, cutover=cutover, cutover_budget=cutover_budget)
    return _dt.from_sortable_bits(ans, x.dtype).reshape(shape)
