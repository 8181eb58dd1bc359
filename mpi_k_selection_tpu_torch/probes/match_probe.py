#!/usr/bin/env python3
# ksel-torch: noqa-file[KSL009] -- a command-line probe: its printed lines are its report
"""Probe of row 5's match-count kernel (``ops/cuda/histogram.py:match_counts``,
the collect of every median, quantiles and many-ranks walk) on one CUDA
card, for timing one commit beside another in one call::

    python3 mpi_k_selection_tpu_torch/probes/match_probe.py [kernel] [e2e] [threshold] [context] [--package DIR]

from the root of the repository (no section named: ``kernel`` and ``e2e``).

- ``kernel``: the kernel alone through the package's wrapper (CUDA events,
  20 calls after 3), held equal to its plain version, at the collects of the
  main path: the median of 2^30 int32 (K=1, 24 resolved bits) and of 2^27
  float64 (K=1, 20 bits), the quantiles 0.5/0.9/0.99/0.999 of both (K=4),
  ``kselect_many`` of 2^27 int32 at K=64 and K=120 evenly spaced ranks (20
  bits), and one hot prefix that every key of 2^27 int32 ``equal`` holds
  (K=1). Prefixes are the answers' top bits, as the collect gets them.
  Beside each: its bound (one read of the words and the K x R int32 counts
  written, at 3.35 TB/s), its plain version (``chip_smoke.py:match_plain``:
  over slices of the prefixes where its temporaries would not fit) and the
  nearest torch composition (``chip_smoke.py:library_match_counts``).
- ``e2e``: the median and the quantiles K=4 of 2^30 int32 and
  ``kselect_many`` K=64 of 2^27 int32, whole calls, with their launches.
- ``threshold``: where the package has ``MATCH_COMPARE_MAX``, the kernel at
  K in {1, 2, 3, 4, 6, 8} under each of its two lookups (the compare in
  registers and the prefix table), forced by setting that constant.
- ``context``: the two medians' collects (K=1) timed again and again in
  one process, after the plain version's temporaries, after
  ``torch.cuda.empty_cache()`` (which ``chip_smoke.py:library_ms`` calls
  before phase 4's next kernel is timed), after a 1 GiB allocation and
  after five medians.

The arrays are made on the card from seed 0 with the main path's value
distributions (``utils/datagen.py``: int32 ``uniform`` in [1, 10^8],
float64 ``normal``, int32 ``equal``). ``--package DIR`` imports
``mpi_k_selection_tpu_torch`` from the checkout at DIR (another commit's
package, built in its own ``_build/``), so that one call can time parent,
change, change, parent. Prints the card's name and power limit first and a
JSON summary last.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (this checkout's; it imports the package only inside its functions)

if "--package" in sys.argv:  # the package of another checkout, ahead of this one's
    sys.path.insert(0, str(pathlib.Path(sys.argv[sys.argv.index("--package") + 1]).resolve()))
from mpi_k_selection_tpu_torch.utils.timing import cuda_ms  # noqa: E402

SECTIONS = ("kernel", "e2e", "threshold", "context")
N30, N27 = 1 << 30, 1 << 27
THRESHOLD_KS = (1, 2, 3, 4, 6, 8)


def datasets(seed: int = 0) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    x30 = torch.randint(1, 100_000_000, (N30,), dtype=torch.int32, device="cuda", generator=g)
    f64 = torch.randn(N27, dtype=torch.float64, device="cuda", generator=g)
    eq = torch.full((N27,), 42, dtype=torch.int32, device="cuda")
    return {"int32 2^30": x30, "int32 2^27": x30[:N27], "float64 2^27": f64, "int32 equal 2^27": eq}


def collect_cases(data: dict) -> list:
    """(label, words, kwargs of match_counts) at the main path's collects."""
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch import api
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    def case(label, name, ranks, res):
        x = data[name]
        bits = 8 * x.element_size()
        key_op, key_xor = ("float", 0) if x.dtype == torch.float64 else ("xor", 1 << 31)
        keys = dt.to_sortable_bits(kt.kselect_many(x, ranks) if len(ranks) > 1 else kt.kselect(x, ranks[0]).view(1))
        prefixes = dt.shift_right_logical(keys, bits - res, bits).contiguous()
        words = x.view(torch.int32 if bits == 32 else torch.int64)
        return label, words, dict(resolved_bits=res, prefixes=prefixes, key_op=key_op, key_xor=key_xor)

    spaced = {k: [round(N27 * (i + 1) / k) for i in range(k)] for k in (64, 120)}
    return [
        case("median 2^30 int32 K=1", "int32 2^30", [N30 // 2], 24),
        case("median 2^27 float64 K=1", "float64 2^27", [N27 // 2], 20),
        case("quantiles 2^30 int32 K=4", "int32 2^30", api.quantile_ranks(cs.QS, N30), 24),
        case("quantiles 2^27 float64 K=4", "float64 2^27", api.quantile_ranks(cs.QS, N27), 20),
        case("many 2^27 int32 K=64", "int32 2^27", spaced[64], 20),
        case("many 2^27 int32 K=120", "int32 2^27", spaced[120], 20),
        case("hot 2^27 int32 equal K=1", "int32 equal 2^27", [N27 // 2], 24),
    ]


def match_bound_ms(words: torch.Tensor, nq: int) -> float:
    """The least time of a match count at the card's memory rate."""
    return cs.match_bytes(words.numel(), 8 * words.element_size(), nq) / cs.HBM_BYTES_PER_S * 1e3


def kernel_rows(cases: list) -> list:
    """Each case's kernel held equal to its plain version and timed, every
    case before any plain or library timing: those free the card's cached
    memory (``torch.cuda.empty_cache``), after which the kernel reads
    slower (the ``context`` section)."""
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H

    rows = []
    for label, words, kw in cases:
        if not torch.equal(H.match_counts(words, **kw), cs.match_plain(words, **kw)):
            cs.fail(f"match_counts != plain at {label}")
        H.reset_counts()
        H.match_counts(words, **kw)
        torch.cuda.synchronize()
        launches = {n: c for n, c in H.LAUNCHES.items() if c}
        ms = cuda_ms(lambda: H.match_counts(words, **kw), iters=20, warmup=3)
        b = match_bound_ms(words, kw["prefixes"].numel())
        rows.append({"what": label, "ms": ms, "bound_ms": b, "share": b / ms, "launches": launches})
    for row, (label, words, kw) in zip(rows, cases):
        row["plain_ms"] = cuda_ms(lambda: cs.match_plain(words, **kw), iters=3, warmup=1)
        row["library_ms"] = cs.library_ms(lambda: cs.library_match_counts(words, **kw),
                                          H.match_counts(words, **kw), label)
        print(f"[kernel] {label:<28} {row['ms']:8.4f} ms  bound {row['bound_ms']:.4f} ms "
              f"({100 * row['share']:5.1f}%)  plain {row['plain_ms']:9.3f} ms  library {row['library_ms']:8.3f} ms  "
              f"launches {row['launches']}")
    return rows


def context_rows(data: dict) -> list:
    """The median collects of the float64 and the 2^30 int32 array (K=1)
    timed in one process after each of: nothing, a second time, the plain
    version's large temporaries (kept by the caching allocator), their
    release (``torch.cuda.empty_cache``), a 1 GiB allocation made and
    freed after that release, and five medians."""
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H

    cases = [c for c in collect_cases(data) if c[0] in ("median 2^27 float64 K=1", "median 2^30 int32 K=1")]
    rows = []

    def reading(after: str) -> None:
        row = {"after": after, "reserved_gib": torch.cuda.memory_reserved() / 2**30}
        for label, words, kw in cases:
            row[label] = cuda_ms(lambda: H.match_counts(words, **kw), iters=20, warmup=3)
        rows.append(row)
        print(f"[context] after {after:<44} " + "  ".join(f"{c[0]} {row[c[0]]:.4f} ms" for c in cases)
              + f"  reserved {row['reserved_gib']:.1f} GiB")

    reading("nothing")
    reading("the same, again")
    _, words, kw = next(c for c in cases if "int32" in c[0])  # its temporaries: about 6 GiB
    cs.match_plain(words, **kw)
    torch.cuda.synchronize()
    reading("the plain version (memory kept)")
    torch.cuda.empty_cache()
    reading("torch.cuda.empty_cache()")
    reading("the same, again")
    torch.empty(1 << 30, dtype=torch.uint8, device="cuda")  # freed at once; the allocator keeps its segment
    reading("a 1 GiB allocation, freed")
    for _ in range(5):
        kt.median(data["int32 2^30"])
    torch.cuda.synchronize()
    reading("five medians")
    return rows


def e2e_rows(data: dict) -> list:
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H

    x30, x27 = data["int32 2^30"], data["int32 2^27"]
    ks = [round(N27 * (i + 1) / 64) for i in range(64)]
    rows = []
    for label, fn in (("median 2^30 int32", lambda: kt.median(x30)),
                      ("quantiles K=4 2^30 int32", lambda: kt.quantiles(x30, cs.QS)),
                      ("kselect_many K=64 2^27 int32", lambda: kt.kselect_many(x27, ks))):
        fn()
        torch.cuda.synchronize()
        H.reset_counts()
        fn()
        torch.cuda.synchronize()
        launches = {n: c for n, c in H.LAUNCHES.items() if c}
        ms = cuda_ms(fn, iters=10, warmup=2)
        rows.append({"what": label, "ms": ms, "launches": launches})
        print(f"[e2e] {label:<30} {ms:9.4f} ms  launches {launches}")
    return rows


def threshold_rows(data: dict) -> list:
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    if not hasattr(H, "MATCH_COMPARE_MAX"):
        print("[threshold] this package has one lookup: skipped")
        return []
    shipped = H.MATCH_COMPARE_MAX
    rows = []
    try:
        for name, res in (("int32 2^30", 24), ("float64 2^27", 20)):
            x = data[name]
            bits = 8 * x.element_size()
            key_op, key_xor = ("float", 0) if x.dtype == torch.float64 else ("xor", 1 << 31)
            words = x.view(torch.int32 if bits == 32 else torch.int64)
            n = x.numel()
            for k in THRESHOLD_KS:
                keys = dt.to_sortable_bits(kt.kselect_many(x, [round(n * (i + 1) / (k + 1)) for i in range(k)]))
                kw = dict(resolved_bits=res, prefixes=dt.shift_right_logical(keys, bits - res, bits).contiguous(),
                          key_op=key_op, key_xor=key_xor)
                want = cs.match_plain(words, **kw)
                row = {"what": f"{name} K={k}", "bound_ms": match_bound_ms(words, k)}
                for lookup, cmax in (("compare", max(THRESHOLD_KS)), ("table", 0)):
                    H.MATCH_COMPARE_MAX = cmax
                    if not torch.equal(H.match_counts(words, **kw), want):
                        cs.fail(f"match_counts ({lookup}) != plain at {name} K={k}")
                    row[f"{lookup}_ms"] = cuda_ms(lambda: H.match_counts(words, **kw), iters=20, warmup=3)
                rows.append(row)
                print(f"[threshold] {row['what']:<20} compare {row['compare_ms']:8.4f} ms  "
                      f"table {row['table_ms']:8.4f} ms  bound {row['bound_ms']:.4f} ms")
                del want
    finally:
        H.MATCH_COMPARE_MAX = shipped
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("match_probe: no CUDA device; this probe runs only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    args = sys.argv[1:]
    if "--package" in args:
        at = args.index("--package")
        del args[at:at + 2]
    unknown = [a for a in args if a not in SECTIONS]
    if unknown:
        raise SystemExit(f"match_probe: unknown arguments {unknown}; sections are {SECTIONS}")
    sections = args or ["kernel", "e2e"]
    import mpi_k_selection_tpu_torch as kt

    print(f"[package] {pathlib.Path(kt.__file__).parent}")
    data = datasets()
    summary = {"device": smi, "package": str(pathlib.Path(kt.__file__).parent)}
    if "kernel" in sections:
        summary["kernel"] = kernel_rows(collect_cases(data))
    if "e2e" in sections:
        summary["e2e"] = e2e_rows(data)
    if "threshold" in sections:
        summary["threshold"] = threshold_rows(data)
    if "context" in sections:
        summary["context"] = context_rows(data)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
