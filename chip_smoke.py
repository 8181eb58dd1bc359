#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mpi_k_selection_tpu_torch``) on one
CUDA card: ``python3 chip_smoke.py`` from the root of the repository.

Phases, each of which must pass (any failure exits non-zero):

1. Build the kernels of ``mpi_k_selection_tpu_torch/csrc`` with ``nvcc``
   and print ``ptxas`` registers, shared memory and spills.
2. Hold each kernel against its plain PyTorch version, exactly (integer
   counts, no tolerance), on 2^27 seeded random words: 32- and 64-bit,
   every ``key_op``, with and without a prefix, and ``match_counts``.
3. Drive the main path through ``kselect`` / ``median`` with the launch
   counts set to 0: the median and k in {1, 250, N/2, N} of 2^30 int32
   ``uniform`` (seed 0), 2^27 float64 ``normal`` and 2^27 int32 ``equal``,
   each answer equal bit for bit to a NumPy ``np.partition`` oracle over the
   same ``datagen`` data, and the median's rank certificate checked. Every
   kernel must have launched.
4. Time on the card with CUDA events (warm): the selects, each kernel at its
   main-path shape, the plain versions, and ``torch.kthvalue`` as a one-call
   yardstick (timed only; the port never calls it). Each time is printed
   beside its bound: the bytes the work must move at 3.35 TB/s. Before it
   is timed, each kernel is held exactly against its plain version on the
   same tensor (a prefix-free pass, a pass under a prefix, and the collect's
   count at 24 bits); the kernels line reports that comparison's error.
5. Profile two medians with ``torch.profiler``: device time by kernel and
   the device's idle share of the median's latency.

The last lines are the card's ``nvidia-smi`` name and power limit, one JSON
object describing every kernel, and
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
OPS_PER_KEY = 5  # xor mask, xor, shift, mask or compare, count
HIST_SRC = "mpi_k_selection_tpu/ops/pallas/histogram.py"
KERNELS = {
    "radix_histogram32": HIST_SRC + ":369",  # pallas_radix_histogram
    "radix_histogram64": HIST_SRC + ":534",  # pallas_radix_histogram64
    "match_counts32": HIST_SRC + ":1023",  # pallas_match_counts
    "match_counts64": HIST_SRC + ":1023",  # pallas_match_counts (64-bit keys)
}
SOURCE = "mpi_k_selection_tpu_torch/csrc/histogram.cu"


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(nbytes: float, nkeys: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the key operations over the scalar rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nkeys * OPS_PER_KEY / SCALAR_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def rand_words(n: int, bits: int, gen) -> torch.Tensor:
    """``n`` uniformly random ``bits``-wide words on the card (every bit
    pattern, NaNs included when read as floats)."""
    w = torch.randint(-(1 << 31), 1 << 31, (n * bits // 32,), dtype=torch.int64, device="cuda", generator=gen)
    w = w.to(torch.int32)
    return w if bits == 32 else w.view(torch.int64)


def phase_build():
    from mpi_k_selection_tpu_torch.ops.cuda import build

    libs = build.build_all()
    for stem, path in libs.items():
        print(f"[build] {stem}: {path.name}")
        for line in build.build_log(path).splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "entry function" in line:
                print(f"[build]   {line.strip()}")
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H

    H._lib()  # load and bind once


def phase_kernels_vs_plain(gen):
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    n = 1 << 27
    err = {name: 0 for name in KERNELS}
    for bits in (32, 64):
        w = rand_words(n, bits, gen)
        for key_op, key_xor in (("none", 0), ("xor", 1 << (bits - 1)), ("float", 0)):
            probe = dt.keys_from_raw(w[n // 3 : n // 3 + 1], key_op, key_xor)
            for rb in (4, 8):
                for shift, live in ((bits - rb, False), (bits - 3 * rb, True), (0, True)):
                    p = dt.shift_right_logical(probe, shift + rb, bits).contiguous() if live else None
                    kw = dict(shift=shift, radix_bits=rb, prefix=p, key_op=key_op, key_xor=key_xor)
                    d = (H.radix_histogram(w, **kw) - H.radix_histogram_plain(w, **kw)).abs().max().item()
                    err[f"radix_histogram{bits}"] = max(err[f"radix_histogram{bits}"], d)
                    if d:
                        fail(f"radix_histogram{bits} != plain at {key_op} rb={rb} shift={shift} prefix={live}")
            for res, nq in ((24, 1), (bits // 2 + 4, 3)):
                keys3 = dt.keys_from_raw(w[[7, n // 3, n - 1]], key_op, key_xor)
                p = dt.shift_right_logical(keys3[:nq], bits - res, bits).contiguous()
                kw = dict(resolved_bits=res, prefixes=p, key_op=key_op, key_xor=key_xor)
                d = (H.match_counts(w, **kw) - H.match_counts_plain(w, **kw)).abs().max().item()
                err[f"match_counts{bits}"] = max(err[f"match_counts{bits}"], d)
                if d:
                    fail(f"match_counts{bits} != plain at {key_op} res={res} K={nq}")
        # a storage offset breaks 16-byte alignment: the scalar loop
        kw = dict(shift=bits - 4, radix_bits=4)
        if not torch.equal(H.radix_histogram(w[1:], **kw), H.radix_histogram_plain(w[1:], **kw)):
            fail(f"radix_histogram{bits} != plain on a misaligned view")
        del w
    torch.cuda.synchronize()
    for name, e in err.items():
        print(f"[check] {name} vs plain at n=2^27: max_abs_err={e}")


def oracle(x: np.ndarray, ks):
    """k-th smallest for each k in key order, as raw bytes."""
    from mpi_k_selection_tpu_torch.utils import dtypes as dt

    keys = dt.np_to_sortable_bits(x)
    part = np.partition(keys, [k - 1 for k in ks])
    return {k: dt.np_from_sortable_bits(part[k - 1 : k], x.dtype).tobytes() for k in ks}


def phase_main_path():
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.utils import datagen
    from mpi_k_selection_tpu_torch.utils.debug import rank_certificate
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy, tensor_to_numpy

    cases = (
        ("int32 uniform 2^30", 1 << 30, "uniform", np.int32),
        ("float64 normal 2^27", 1 << 27, "normal", np.float64),
        ("int32 equal 2^27", 1 << 27, "equal", np.int32),
    )
    data = {}
    wants = {}
    for label, n, pattern, dtype in cases:
        x = datagen.generate(n, pattern=pattern, seed=0, dtype=dtype)
        ks = (1, 250, n // 2, n)
        wants[label] = oracle(x, ks)
        data[label] = tensor_from_numpy(x, "cuda")
        del x
    torch.cuda.synchronize()

    H.reset_counts()
    answers = {}
    per_median = {}
    for label, _, _, _ in cases:
        x = data[label]
        n = x.numel()
        before = dict(H.LAUNCHES)
        answers[(label, n // 2)] = kt.median(x)
        per_median[label] = {kn: v - before[kn] for kn, v in H.LAUNCHES.items() if v > before[kn]}
        for k in (1, 250, n):
            answers[(label, k)] = kt.kselect(x, k)
    torch.cuda.synchronize()
    launches = dict(H.LAUNCHES)
    plain = dict(H.PLAIN_CALLS)

    for (label, k), ans in answers.items():
        got = tensor_to_numpy(ans.reshape(1))
        if got.tobytes() != wants[label][k]:
            fail(f"{label} k={k}: got {got[0]!r}, oracle {np.frombuffer(wants[label][k], got.dtype)[0]!r}")
        print(f"[main] {label} k={k}: {got[0]!r} == oracle")
    for label, _, _, _ in cases:
        n = data[label].numel()
        less, leq = rank_certificate(data[label], answers[(label, n // 2)])
        if not int(less) < n // 2 <= int(leq):
            fail(f"{label} median rank certificate ({int(less)}, {int(leq)}]")
    for label, counts in per_median.items():
        print(f"[main] launches of one median, {label}: {counts}")
    print(f"[main] launches {launches}; plain calls {plain}")
    if any(v == 0 for v in launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    if any(plain.values()):
        fail(f"the plain versions ran on the card's main path: {plain}")
    return data, launches


def phase_timing(data):
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.ops.cuda import histogram as H
    from mpi_k_selection_tpu_torch.utils import dtypes as dt
    from mpi_k_selection_tpu_torch.utils.timing import cuda_ms

    x30 = data["int32 uniform 2^30"]
    f64 = data["float64 normal 2^27"]
    eq = data["int32 equal 2^27"]
    x27 = x30[: 1 << 27]
    i64 = x27.to(torch.int64)
    rows = []

    def row(what, n, itemsize, ms, extra=""):
        b, by = bound(n * itemsize, n)
        rows.append({"what": what, "n": n, "ms": ms, "bound_ms": b, "bound_by": by})
        print(f"[time] {what:<44} {ms:10.4f} ms   bound {b:8.4f} ms ({by}){extra}")

    for label, x in (("median int32 uniform 2^30", x30), ("median int32 uniform 2^27", x27),
                     ("median int64 uniform 2^27", i64), ("median float64 normal 2^27", f64),
                     ("median int32 equal 2^27", eq)):
        ms = cuda_ms(lambda: kt.median(x), iters=5)
        row(label, x.numel(), x.element_size(), ms)
        kms = cuda_ms(lambda: torch.kthvalue(x, max(1, x.numel() // 2)), iters=2, warmup=1)
        row(label.replace("median", "torch.kthvalue"), x.numel(), x.element_size(), kms)

    def exact(kernel, plain, what, **kw):
        """max |kernel - plain| over the outputs; any difference fails."""
        d = (kernel(**kw) - plain(**kw)).abs().max().item()
        if d:
            fail(f"{what} != plain at the main path's shape: max_abs_err={d}")
        return d

    # each kernel at the shapes the main path gives it, held exactly against
    # its plain version on the same tensor it is timed on (the prefix-free
    # first pass, a pass under the prefix of a key in the data, and the
    # collect's count at the cutover width of the 2^30 median, 24 bits)
    kern = {}
    for name, words, key_op, key_xor, bits in (
        ("32 int32 2^30", x30, "xor", 1 << 31, 32), ("32 int32 2^27", x27, "xor", 1 << 31, 32),
        ("32 int32 equal 2^27", eq, "xor", 1 << 31, 32), ("64 int64 2^27", i64, "xor", 1 << 63, 64),
        ("64 float64 2^27", f64, "float", 0, 64),
    ):
        w = words.view(torch.int32 if bits == 32 else torch.int64)
        n = w.numel()
        key = dt.keys_from_raw(w[n // 2 : n // 2 + 1], key_op, key_xor)
        kw = dict(words=w, shift=bits - 4, radix_bits=4, key_op=key_op, key_xor=key_xor)
        kwp = dict(kw, shift=bits - 12, prefix=dt.shift_right_logical(key, bits - 8, bits).contiguous())
        mkw = dict(words=w, resolved_bits=24, key_op=key_op, key_xor=key_xor,
                   prefixes=dt.shift_right_logical(key, bits - 24, bits).contiguous())
        herr = max(exact(H.radix_histogram, H.radix_histogram_plain, f"radix_histogram{name}", **kw),
                   exact(H.radix_histogram, H.radix_histogram_plain, f"radix_histogram{name} prefix", **kwp))
        merr = exact(H.match_counts, H.match_counts_plain, f"match_counts{name}", **mkw)
        print(f"[check] radix_histogram{name} (with and without a prefix) and match_counts{name} "
              f"== plain: max_abs_err {herr}, {merr}")
        ms = cuda_ms(lambda: H.radix_histogram(**kw))
        pms = cuda_ms(lambda: H.radix_histogram_plain(**kw), iters=3, warmup=1)
        row(f"radix_histogram{name}", n, bits // 8, ms, f"   plain {pms:.4f} ms")
        mms = cuda_ms(lambda: H.match_counts(**mkw))
        mpms = cuda_ms(lambda: H.match_counts_plain(**mkw), iters=3, warmup=1)
        rows_out = -(-n // 128) * 4
        b, by = bound(n * bits // 8 + rows_out, n)
        rows.append({"what": f"match_counts{name}", "n": n, "ms": mms, "bound_ms": b, "bound_by": by})
        print(f"[time] {'match_counts' + name:<44} {mms:10.4f} ms   bound {b:8.4f} ms ({by})   plain {mpms:.4f} ms")
        if name in ("32 int32 2^30", "64 float64 2^27"):
            kern[f"radix_histogram{bits}"] = (ms, pms, *bound(n * bits // 8, n), herr)
            kern[f"match_counts{bits}"] = (mms, mpms, b, by, merr)
        torch.cuda.empty_cache()
    return rows, kern


def phase_profile(x: torch.Tensor, label: str, median_ms: float):
    """Device time by kernel for three medians of ``x`` (torch.profiler),
    and the device's busy share of the median's event-timed latency."""
    import mpi_k_selection_tpu_torch as kt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = 3
    kt.median(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kt.median(x)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): the host ops that launch
    # them report the same time again
    dev = [
        (e.key, e.count // reps, e.self_device_time_total / 1e3 / reps)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]
    dev = sorted((d for d in dev if d[2] > 0), key=lambda d: -d[2])
    busy = sum(d[2] for d in dev)
    if not dev:
        print(f"[profile] {label}: the profiler saw no device time; breakdown not measured")
        return None
    for name, calls, ms in dev[:12]:
        print(f"[profile] {label}: {ms:9.4f} ms  {calls:4d}x  {name[:90]}")
    idle = max(0.0, 1.0 - busy / median_ms)
    print(f"[profile] {label}: device busy {busy:.4f} ms of {median_ms:.4f} ms per median; idle share {idle:.3f}")
    return {"what": label, "busy_ms": busy, "median_ms": median_ms, "idle_share": idle,
            "top": [{"name": n[:120], "calls": c, "ms": m} for n, c, m in dev[:12]]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    import mpi_k_selection_tpu_torch  # noqa: F401  (fails here, before any output, outside the repo)

    torch.cuda.init()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_build()
    phase_kernels_vs_plain(gen)
    data, launches = phase_main_path()
    rows, kern = phase_timing(data)
    profiles = [
        phase_profile(data[label], label, next(r["ms"] for r in rows if r["what"] == "median " + label))
        for label in ("int32 uniform 2^30", "float64 normal 2^27")
    ]

    kernels = []
    for kname, replaces in KERNELS.items():
        ms, pms, b, by, err = kern[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": b, "bound_by": by, "library_ms": None,
        })
    print(json.dumps({"timings": rows, "profiles": profiles}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
