#!/usr/bin/env python3
# ksel-torch: noqa-file[KSL009] -- a command-line probe: its printed lines are its report
"""Probe of the sweep kernel's order-free route (``csrc/sweep_ingest.cu``)
on one CUDA card: ``python3 mpi_k_selection_tpu_torch/probes/sweep_probe.py
[loads] [copies] [sketch] [kinds] [variants] [placement] [context] [--package DIR]`` from the
root of the repository.

1. Loads: the shipped kernel and the two kernels of ``sweep_loads.cu`` beside
   this file (built here with ``nvcc`` into the package's ``_build/``) count one digit histogram under one prefix and
   the certificate pair of the streamed int32 chunk (2^26 words, values in
   [1, 10^8]) and of a float64 chunk (2^25 words) keyed by xor: with 4
   16-byte loads in flight per thread (the shipped route's way) and with a
   ring of 3 or 4 shared-memory stages of 16 KB filled by ``cp.async.bulk``,
   each alone and with 16 KB more shared memory a block (what the shipped
   kernel keeps for 4 prefixes: sub-histogram copies and the prefix table),
   which lowers the blocks an SM holds. All agree exactly, or the probe
   fails; each prints its device time (torch.profiler) beside the one-read
   bound.
2. Sub-histogram copies: the shipped kernel on the streamed passes' shapes
   (the top digit, and 4 distinct 16-bit prefixes) with the copies' cap
   (``ops/cuda/sweep_ingest.py:COPIES_SMEM``) at 1/32 .. 1/2 of an SM's
   shared memory, each cap's copies and device time.
3. Sketch counting: ``csrc/sweep_ingest.cu`` built once for each way the
   warps' counts meet their counters (``AGG_MODES``: 0, an atomic a key;
   1, one atomic when the whole warp holds one bin; 2,
   ``__match_any_sync`` groups; 3, the shipped one, those groups in a warp
   step whose first keys look hot). Modes 0-2 are copies of the source
   made here, in the build directory, with the shipped ``warp_count``
   swapped for ``AGG_VARIANTS[mode]`` and no step taken as hot. Each is timed on the sketch at 16 bits
   (16-bit counters in shared memory) and 20 bits (global int32) of the
   streamed int32 chunk 0, the float64 chunk 0, a one-hot int32 chunk and
   an int32 chunk of two hot counters in alternating keys; on the first
   histogram pass and the all-parts launch (ordered route, a 20-bit
   sketch) of the streamed chunks; and on 2^26 bfloat16 keys through the
   sketch consumer's launch (a 16-bit histogram, a 1-bit sketch); each
   equal to the plain version.
4. Launch kinds: the sweep kernel of the package in use on each launch
   kind ``chip_smoke.py`` times for PERF.md's row 8 (``sweep_kinds`` and
   the spill passes' histogram + tee kinds, ``tee_kinds``, on the streamed
   int32 and float64 chunks 0) and on the ordered route's
   checked kernel (a histogram of the top digit beside one collect spec,
   and all five parts with a 20-bit sketch, each on 2^26 words, as in
   ``chip_smoke.py`` phase 4), each equal to the plain version, its device
   time (torch.profiler). ``--package DIR`` imports
   ``mpi_k_selection_tpu_torch`` from the checkout at DIR (another
   commit's package, built in its own ``_build/``), so that two versions
   can be timed in one call: parent, change, change, parent.
5. Variants: the tee kinds, the collect kinds and one order-free kind
   (a control) on the same chunks under other builds and layouts of the
   ordered route (``VARIANTS``): the checked kernel for histogram launches,
   the next tile's loads issued after the count (not before it), 8
   sub-histogram copies in place of 16, every tee spec compared
   (no lookup), and blocks of 512 threads in place of 1024; the shipped
   build
   first and last, each equal to the plain version. The builds are copies
   of ``csrc/sweep_ingest.cu`` made in the build directory.
6. Placement: the 64-bit all-parts launch of section 4 with its arena
   of counters placed after pads of growing size held on the card, each
   time beside the address of its sketch counters.
7. Context: the same launch in a fresh process, then after
   ``chip_smoke.py``'s phase-2 checks of the sweep kernel in that process.

Sections named on the command line (``loads``, ``copies``, ``sketch``,
``kinds``, ``variants``, ``placement``, ``context``) run alone; with none, the first three. Prints the card's name
and power limit first and a JSON summary last.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (this checkout's; it imports the package only inside its functions)

if "--package" in sys.argv:  # the package of another checkout, ahead of this one's
    sys.path.insert(0, str(pathlib.Path(sys.argv[sys.argv.index("--package") + 1]).resolve()))
from mpi_k_selection_tpu_torch.ops.cuda import build  # noqa: E402
from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S  # noqa: E402
from mpi_k_selection_tpu_torch.utils import datagen  # noqa: E402
from mpi_k_selection_tpu_torch.utils import dtypes as dt  # noqa: E402

SRC = pathlib.Path(__file__).resolve().with_name("sweep_loads.cu")
LOADS = {0: "regs_kernel", 3: "bulk_kernel", 4: "bulk_kernel"}  # which: kernel name
PADS = (0, 16 * 1024)  # more shared memory a block: none, and the shipped kernel's for 4 prefixes


def build_probe() -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = build.BUILD_DIR / "libsweep_loads-probe.so"
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(SRC)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    probe = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for bits, xt in ((32, ctypes.c_uint32), (64, ctypes.c_uint64)):
        f = getattr(probe, f"probe_loads{bits}")
        f.argtypes = [i, i, p, ll, xt, xt, i, i, xt, p, p, i, p]
        f.restype = i
    return probe


def loads(probe, sms: int) -> list:
    out = []
    chunks = {32: datagen.generate(1 << 26, pattern="uniform", seed=0, dtype=np.int32),
              64: datagen.generate(1 << 25, pattern="normal", seed=0, dtype=np.float64).view(np.int64)}
    for bits, c in chunks.items():
        w = torch.from_numpy(c).cuda()
        n = w.numel()
        xor = 1 << (bits - 1)
        u = c.view(np.uint32 if bits == 32 else np.uint64)
        keys = u ^ u.dtype.type(xor)
        med = int(np.partition(keys, n // 2)[n // 2])
        shift, rb, p8 = bits - 16, 8, med >> (bits - 8)
        kw = dict(key_op="xor", key_xor=xor, hist_prefixes=[p8], shift=shift, radix_bits=rb, vkey=med)
        hist, _, _, cert, _ = S.sweep_ingest(w, n, **kw)
        want = (hist[0].clone(), torch.stack(cert).clone())
        bound_ms = n * bits / 8 / cs.HBM_BYTES_PER_S * 1e3
        ms = cs.kernel_device_ms(lambda: S.sweep_ingest(w, n, **kw), "sweep_ingest_kernel")
        print(f"[loads] {bits}-bit, {n} words: shipped kernel {ms:.4f} ms ({bound_ms / ms:.0%} of {bound_ms:.4f} ms)")
        out.append({"bits": bits, "kernel": "shipped", "ms": ms, "bound_ms": bound_ms})
        f = getattr(probe, f"probe_loads{bits}")
        stream = torch.cuda.current_stream().cuda_stream
        for pad in PADS:
            for which, name in LOADS.items():
                h = torch.zeros(1 << rb, dtype=torch.int32, device="cuda")
                ce = torch.zeros(2, dtype=torch.int32, device="cuda")

                def call():
                    h.zero_()
                    ce.zero_()
                    rc = f(which, pad, w.data_ptr(), n, xor, p8, shift, rb, med, h.data_ptr(), ce.data_ptr(), sms,
                           stream)
                    if rc:
                        raise SystemExit(f"probe kernel {which} failed: {rc}")

                call()
                torch.cuda.synchronize()
                if not (torch.equal(h, want[0]) and torch.equal(ce, want[1])):
                    raise SystemExit(f"probe kernel {which} ({bits}-bit) disagrees with the shipped kernel")
                pms = cs.kernel_device_ms(call, name)
                label = "16-byte loads in registers" if which == 0 else f"cp.async.bulk ring of {which} stages"
                print(f"[loads] {bits}-bit: {label}, {pad} more bytes of shared memory a block: {pms:.4f} ms "
                      f"({bound_ms / pms:.0%}); equal to the shipped kernel")
                out.append({"bits": bits, "kernel": label, "pad": pad, "ms": pms, "bound_ms": bound_ms})
        del w
        torch.cuda.empty_cache()
    return out


def copies() -> list:
    out = []
    default = S.COPIES_SMEM
    chunks = {32: datagen.generate(1 << 26, pattern="uniform", seed=0, dtype=np.int32),
              64: datagen.generate(1 << 25, pattern="normal", seed=0, dtype=np.float64)}
    try:
        for bits, c in chunks.items():
            w = torch.from_numpy(c.view(np.int32 if bits == 32 else np.int64)).cuda()
            n = w.numel()
            key_op, xor = ("xor", 1 << 31) if bits == 32 else ("float", 0)
            kinds = [k for k in cs.sweep_kinds(bits, c) if k[0].startswith("hist") and "1 prefix" not in k[0]]
            for frac in (32, 16, 8, 4, 2):
                S.COPIES_SMEM = S.SMEM_PER_SM // frac
                S._layout.cache_clear()
                for label, parts in kinds:
                    kw = dict(key_op=key_op, key_xor=xor, **parts)
                    plan = S.sweep_plan(bits, n, nd=len(parts["hist_prefixes"]), shift=parts["shift"],
                                        radix_bits=parts["radix_bits"], sms=1)
                    ms = cs.kernel_device_ms(lambda: S.sweep_ingest(w, n, **kw), "sweep_ingest_kernel")
                    print(f"[copies] {bits}-bit {label}: cap 1/{frac} of an SM's shared memory "
                          f"({S.COPIES_SMEM} bytes): {plan.copies} copies, {plan.smem} bytes a block, {ms:.4f} ms")
                    out.append({"bits": bits, "kind": label, "cap_fraction": 1 / frac, "copies": plan.copies,
                                "smem": plan.smem, "ms": ms})
            del w
            torch.cuda.empty_cache()
    finally:
        S.COPIES_SMEM = default
        S._layout.cache_clear()
    return out


AGG_MODES = {0: "an atomic a key", 1: "one atomic when the warp holds one bin", 2: "__match_any_sync groups",
             3: "__match_any_sync groups where a step looks hot (shipped)"}
# warp_count of modes 0-2, each in place of the shipped one (kHot is never
# set: their copies take no step as hot)
AGG_VARIANTS = {
    0: "  if (on) add(bin, 1u);",
    1: """  const unsigned act = __ballot_sync(0xffffffffu, on);
  const int first = __ffs(act) - 1;  // -1: no lane counts
  const unsigned b0 = __shfl_sync(0xffffffffu, bin, first & 31);
  if (__ballot_sync(0xffffffffu, on && bin == b0) == act) {
    if (lane == first) add(bin, (unsigned)__popc(act));
  } else if (on) {
    add(bin, 1u);
  }""",
    2: """  const unsigned peers = __match_any_sync(0xffffffffu, on ? bin : ~0u);
  if (on && lane == __ffs(peers) - 1) add(bin, (unsigned)__popc(peers));""",
}
WARP_COUNT = re.compile(r"(__device__ __forceinline__ void warp_count\(bool on, unsigned bin, int lane, F add\) \{\n)"
                        r"(.*?)(\n\}\n)", re.S)
HOT_OF = "  auto hot_of = [&](W k) -> bool {\n"


def agg_source(mode: int) -> pathlib.Path:
    """``csrc/sweep_ingest.cu``, or for modes 0-2 a copy of it with
    ``AGG_VARIANTS[mode]`` as ``warp_count``'s body and ``hot_of`` false."""
    src = build.SRC_DIR / "sweep_ingest.cu"
    if mode == 3:
        return src
    text = src.read_text()
    if len(WARP_COUNT.findall(text)) != 1 or text.count(HOT_OF) != 1:
        raise SystemExit("sweep_probe: csrc/sweep_ingest.cu no longer has one warp_count and one hot_of to swap")
    text = WARP_COUNT.sub(lambda m: m.group(1) + AGG_VARIANTS[mode] + m.group(3), text)
    text = text.replace(HOT_OF, HOT_OF + "    return false;\n")
    out = build.BUILD_DIR / f"sweep_ingest-agg{mode}.cu"
    out.write_text(text)
    return out


def build_agg(mode: int) -> pathlib.Path:
    """The library of :func:`agg_source` for ``mode``."""
    lib = build.BUILD_DIR / f"libsweep_ingest-agg{mode}.so"
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(agg_source(mode))],
                       capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise SystemExit(f"nvcc failed (aggregation mode {mode}):\n{r.stdout}{r.stderr}")
    return lib


def sketch_agg() -> list:
    import concurrent.futures

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(AGG_MODES)) as pool:  # one nvcc each, all at once
        libs = dict(zip(AGG_MODES, pool.map(build_agg, AGG_MODES)))
    n = 1 << 26
    alt = torch.full((n,), 0x7FFE1234, dtype=torch.int32, device="cuda")
    alt[1::2] = 0x7FFF1234
    gen = torch.Generator(device="cuda").manual_seed(16)
    bf16 = dt.to_sortable_bits(torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16))
    sketches = [("sketch 16", dict(sketch_bits=16)), ("sketch 20", dict(sketch_bits=20))]
    chunks = {  # label: (words, key_op, key_xor, kinds)
        "int32 chunk 0": (torch.from_numpy(datagen.generate(n, pattern="uniform", seed=0, dtype=np.int32)).cuda(),
                          "xor", 1 << 31, sketches + [("hist, no prefix (pass 0)", dict(hist_prefixes=[0], shift=24,
                                                                                          radix_bits=8))]),
        "float64 chunk 0": (torch.from_numpy(datagen.generate(n // 2, pattern="normal", seed=0,
                                                              dtype=np.float64).view(np.int64)).cuda(), "float", 0,
                            list(sketches)),
        "one-hot int32": (torch.full((n,), 12345, dtype=torch.int32, device="cuda"), "xor", 1 << 31, list(sketches)),
        "two hot counters alternating": (alt, "none", 0, list(sketches)),
        "bfloat16 keys": (bf16, "none", 0, [("16-bit histogram + 1-bit sketch", dict(
            hist_prefixes=[0], shift=0, radix_bits=16, sketch_bits=1))]),
    }
    for label in ("int32 chunk 0", "float64 chunk 0"):  # the ordered route's all-parts launch
        w, key_op, xor, kinds = chunks[label]
        bits = w.element_size() * 8
        k = [v & ((1 << bits) - 1) for v in dt.keys_from_raw(w[:8], key_op, xor).tolist()]
        kinds.append(("all five parts, sketch 20", dict(
            hist_prefixes=[k[0] >> (bits - 8), k[1] >> (bits - 8)], shift=bits - 16, radix_bits=8,
            collect=[(bits - 16, k[2] >> (bits - 16))], tee=[(bits - 8, k[0] >> (bits - 8)), (bits - 16, k[3] >> (bits - 16))],
            vkey=k[4], sketch_bits=20)))
    shipped = build._libs.pop("sweep_ingest", None)
    out = []
    try:
        for mode, path in libs.items():
            build._libs["sweep_ingest"] = ctypes.CDLL(str(path))
            for label, (w, key_op, xor, kinds) in chunks.items():
                for kind, kw in kinds:
                    kw = dict(key_op=key_op, key_xor=xor, **kw)
                    cs.sweep_err(S.sweep_ingest(w, w.numel(), **kw), S.sweep_ingest_plain(w, w.numel(), **kw),
                                 f"aggregation mode {mode} {label} {kind}")
                    ms = cs.kernel_device_ms(lambda: S.sweep_ingest(w, w.numel(), **kw), "sweep_ingest_kernel")
                    shown = "not measured (the profiler saw no kernel)" if ms is None else f"{ms:.4f} ms"
                    print(f"[agg] mode {mode} ({AGG_MODES[mode]}): {label}, {kind}: {shown}; "
                          f"equal to the plain version")
                    out.append({"mode": mode, "chunk": label, "kind": kind, "ms": ms})
    finally:
        build._libs.pop("sweep_ingest", None)
        if shipped is not None:
            build._libs["sweep_ingest"] = shipped
    del chunks, alt, bf16
    torch.cuda.empty_cache()
    return out


def checked_kinds(bits: int, chunk: np.ndarray) -> list:
    """(label, parts) of the ordered route's checked kernel on 2^26 words,
    as ``chip_smoke.py`` phase 4 lays them out from ``chunk``'s first keys:
    a histogram of the top digit beside one collect spec, and all five
    parts with a 20-bit sketch (in global memory)."""
    keys = cs.host_keys(chunk[:8])
    p8 = int(keys[0]) >> (bits - 8)
    return [
        ("hist K=1 + one collect spec, 2^26 words", dict(
            hist_prefixes=[0], shift=bits - 8, radix_bits=8, collect=[(bits - 24, int(keys[0]) >> (bits - 24))])),
        ("all five parts, 2^26 words", dict(
            hist_prefixes=[p8, int(keys[1]) >> (bits - 8)], shift=bits - 16, radix_bits=8,
            collect=[(bits - 16, int(keys[2]) >> (bits - 16))],
            tee=[(bits - 8, p8), (bits - 16, int(keys[3]) >> (bits - 16))], vkey=int(keys[4]), sketch_bits=20)),
    ]


def kinds() -> list:
    from mpi_k_selection_tpu_torch import __file__ as pkg

    print(f"[kinds] package {pathlib.Path(pkg).parent}")
    out = []
    ints = cs.make_chunks(1, cs.STREAM_CHUNK, "uniform", np.int32)
    f64 = cs.make_chunks(2, cs.F64_CHUNK, "normal", np.float64)
    for bits, c, key_op, key_xor in ((32, ints[0], "xor", 1 << 31), (64, f64[0], "float", 0)):
        w = torch.from_numpy(c.view(np.int32 if bits == 32 else np.int64)).cuda()
        w26 = w if bits == 32 else torch.from_numpy(np.concatenate(f64).view(np.int64)).cuda()
        for words, group in ((w, cs.sweep_kinds(bits, c) + cs.tee_kinds(bits, c)), (w26, checked_kinds(bits, c))):
            n = words.numel()
            for label, parts in group:
                kw = dict(key_op=key_op, key_xor=key_xor, **parts)
                cs.sweep_err(S.sweep_ingest(words, n, **kw), S.sweep_ingest_plain(words, n, **kw),
                             f"sweep_ingest{bits} {label}")
                ms = cs.kernel_device_ms(lambda: S.sweep_ingest(words, n, **kw), "sweep_ingest_kernel")
                shown = "not measured (the profiler saw no kernel)" if ms is None else f"{ms:.4f} ms"
                print(f"[kinds] sweep_ingest{bits} {label} ({n} words): kernel alone {shown}; equal to the plain version")
                out.append({"bits": bits, "kind": label, "words": n, "ms": ms})
        del w, w26
        torch.cuda.empty_cache()
    return out


# The ordered route built and laid out other ways: name -> (text swaps of
# csrc/sweep_ingest.cu, made in a copy in the build directory; attributes
# of ops/cuda/sweep_ingest.py set for the variant's launches).
VARIANTS = {
    "shipped": ((), ()),
    "the checked kernel for histogram launches": (
        (("parts == kPartHist ? sweep_ingest_kernel<W, true, kPartHist, false>",
          "parts == kPartHist ? sweep_ingest_kernel<W, true, kPartsChecked, false>"),), ()),
    "the next tile's loads issued after the count": (
        (("      if (takes) {\n        const int nst", "      if (false) {\n        const int nst"),
         ("        if (!kHist || nd <= 1)\n          count_rows(Int<0>{});",
          "        if (takes) {\n          const int nst = (cur.st + 1) % kStages;\n"
          "          const long long t = __shfl_sync(0xffffffffu, (long long)ticket, 0);\n"
          "          if (lane == 0) s_ticket[nst] = t;\n          if (t < n_tiles) load_tile(t, nst);\n        }\n"
          "        if (!kHist || nd <= 1)\n          count_rows(Int<0>{});")), ()),
    "8 sub-histogram copies (four warps a copy)": ((), (("ORDERED_COPIES", (8, 4, 2)),)),
    "every tee spec compared (no lookup)": ((), (("teed_prefixes", lambda shift, rb, distinct, tee: ([], list(tee))),)),
    "512 threads (16 warps) a block": (
        (("constexpr int kOrdThreads = 1024;", "constexpr int kOrdThreads = 512;"),), (("ORD_THREADS", 512),)),
}


def build_variant(i: int) -> pathlib.Path:
    """The library of variant ``i`` of :data:`VARIANTS` (the shipped one
    as it is), its ordered kernels' registers and spills printed."""
    name, (swaps, _) = list(VARIANTS.items())[i]
    src = build.SRC_DIR / "sweep_ingest.cu"
    if swaps:
        text = src.read_text()
        for old, new in swaps:
            if text.count(old) != 1:
                raise SystemExit(f"sweep_probe: csrc/sweep_ingest.cu no longer holds {old!r} once")
            text = text.replace(old, new)
        src = build.BUILD_DIR / f"sweep_ingest-var{i}.cu"
        src.write_text(text)
    lib = build.BUILD_DIR / f"libsweep_ingest-var{i}.so"
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                       capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise SystemExit(f"nvcc failed (variant {name}):\n{r.stdout}{r.stderr}")
    entry = ""
    for line in (r.stdout + r.stderr).splitlines():
        if "entry function" in line:
            entry = "ordered" if "Lb1ELi" in line else ""  # sweep_ingest_kernel<W, true, ...>
            kernel = line.split("'")[1] if "'" in line else line
        elif entry and ("registers" in line or "spill" in line):
            print(f"[variants] {name}: {kernel[-40:]}: {line.strip()}")
    return lib


def variants() -> list:
    """The tee kinds, the collect kinds and one order-free kind (a
    control) on the streams' chunks 0 under each of :data:`VARIANTS`, the
    shipped one first and last, each equal to the plain version."""
    import concurrent.futures

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc each, all at once
        libs = list(pool.map(build_variant, range(len(VARIANTS))))
    ints = cs.make_chunks(1, cs.STREAM_CHUNK, "uniform", np.int32)
    f64 = cs.make_chunks(1, cs.F64_CHUNK, "normal", np.float64)
    chunks = []
    for bits, c, key_op, key_xor in ((32, ints[0], "xor", 1 << 31), (64, f64[0], "float", 0)):
        kinds = [k for k in cs.sweep_kinds(bits, c) if k[0].startswith(("collect", "hist, 1 prefix"))]
        chunks.append((bits, torch.from_numpy(c.view(np.int32 if bits == 32 else np.int64)).cuda(), key_op, key_xor,
                       kinds + cs.tee_kinds(bits, c)))
    shipped = build._libs.pop("sweep_ingest", None)
    order = list(range(len(VARIANTS))) + [0]
    out = []
    try:
        for i in order:
            name, (_, attrs) = list(VARIANTS.items())[i]
            saved = {a: getattr(S, a) for a, _ in attrs}
            build._libs["sweep_ingest"] = ctypes.CDLL(str(libs[i]))
            try:
                for a, v in attrs:
                    setattr(S, a, v)
                S._layout.cache_clear()
                for bits, w, key_op, key_xor, kinds in chunks:
                    n = w.numel()
                    for label, parts in kinds:
                        kw = dict(key_op=key_op, key_xor=key_xor, **parts)
                        cs.sweep_err(S.sweep_ingest(w, n, **kw), S.sweep_ingest_plain(w, n, **kw),
                                     f"variant {name}: sweep_ingest{bits} {label}")
                        ms = cs.kernel_device_ms(lambda: S.sweep_ingest(w, n, **kw), "sweep_ingest_kernel")
                        shown = "not measured (the profiler saw no kernel)" if ms is None else f"{ms:.4f} ms"
                        print(f"[variants] {name}: sweep_ingest{bits} {label}: kernel alone {shown}; "
                              f"equal to the plain version")
                        out.append({"variant": name, "bits": bits, "kind": label, "ms": ms})
            finally:
                for a, v in saved.items():
                    setattr(S, a, v)
                S._layout.cache_clear()
    finally:
        build._libs.pop("sweep_ingest", None)
        if shipped is not None:
            build._libs["sweep_ingest"] = shipped
    del chunks
    torch.cuda.empty_cache()
    return out


PLACEMENT_PADS_MIB = (0, 2, 6, 14, 30, 62, 126, 254, 510, 1022)


def placement() -> list:
    """The 64-bit all-parts launch of :func:`checked_kinds` (its 20-bit
    sketch counts in global memory: its time is that of the atomics on a
    few hot counters) with its arena of counters placed after a pad of
    each size in ``PLACEMENT_PADS_MIB`` held on the card, each equal to
    the plain version: how its device time moves with where its counters
    lie. Prints the counters' address beside each time."""
    from mpi_k_selection_tpu_torch import __file__ as pkg

    print(f"[placement] package {pathlib.Path(pkg).parent}")
    f64 = cs.make_chunks(2, cs.F64_CHUNK, "normal", np.float64)
    w = torch.from_numpy(np.concatenate(f64).view(np.int64)).cuda()
    n = w.numel()
    label, parts = checked_kinds(64, f64[0])[1]
    kw = dict(key_op="float", key_xor=0, **parts)
    cs.sweep_err(S.sweep_ingest(w, n, **kw), S.sweep_ingest_plain(w, n, **kw), f"sweep_ingest64 {label}")
    out = []
    for mib in PLACEMENT_PADS_MIB:
        torch.cuda.empty_cache()
        pad = torch.empty(mib << 20, dtype=torch.uint8, device="cuda")
        deep = S.sweep_ingest(w, n, **kw)[4][0]
        addr = deep.data_ptr()
        del deep
        ms = cs.kernel_device_ms(lambda: S.sweep_ingest(w, n, **kw), "sweep_ingest_kernel")
        print(f"[placement] sweep_ingest64 {label}, a pad of {mib} MiB: the sketch's counters at {addr:#x}; "
              f"kernel alone {ms:.4f} ms")
        out.append({"pad_mib": mib, "deep_addr": addr, "ms": ms})
        del pad
    del w
    torch.cuda.empty_cache()
    return out


def context() -> list:
    """The 64-bit all-parts launch of :func:`checked_kinds` timed in this
    fresh process, then again after ``chip_smoke.py``'s phase-2 checks of
    the sweep kernel (``sweep_vs_plain``: every part set, the skewed
    sketches, the 16-bit dtypes) ran in the same process."""
    from mpi_k_selection_tpu_torch import __file__ as pkg

    print(f"[context] package {pathlib.Path(pkg).parent}")
    f64 = cs.make_chunks(2, cs.F64_CHUNK, "normal", np.float64)
    w = torch.from_numpy(np.concatenate(f64).view(np.int64)).cuda()
    n = w.numel()
    label, parts = checked_kinds(64, f64[0])[1]
    kw = dict(key_op="float", key_xor=0, **parts)
    cs.sweep_err(S.sweep_ingest(w, n, **kw), S.sweep_ingest_plain(w, n, **kw), f"sweep_ingest64 {label}")
    out = []
    for when in ("fresh", "after chip_smoke.py's phase-2 sweep checks"):
        if when != "fresh":
            cs.sweep_vs_plain(torch.Generator(device="cuda").manual_seed(0), {"sweep_ingest32": 0, "sweep_ingest64": 0})
        ms = cs.kernel_device_ms(lambda: S.sweep_ingest(w, n, **kw), "sweep_ingest_kernel")
        print(f"[context] sweep_ingest64 {label}, {when}: kernel alone {ms:.4f} ms")
        out.append({"when": when, "ms": ms})
    del w
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_probe: no CUDA device; this probe runs only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    args = sys.argv[1:]
    if "--package" in args:
        del args[args.index("--package"):args.index("--package") + 2]
    sections = args or ["loads", "copies", "sketch"]
    if set(sections) - {"loads", "copies", "sketch", "kinds", "variants", "placement", "context"}:
        raise SystemExit(f"sweep_probe: unknown sections {sections}; choose from loads, copies, sketch, kinds, "
                         "variants, placement, context")
    build.build_all(["sweep_ingest"])
    summary = {"device": smi}
    if "loads" in sections:
        summary["loads"] = loads(build_probe(), torch.cuda.get_device_properties(0).multi_processor_count)
    if "copies" in sections:
        summary["copies"] = copies()
    if "sketch" in sections:
        summary["sketch_agg"] = sketch_agg()
    if "kinds" in sections:
        summary["kinds"] = kinds()
    if "variants" in sections:
        summary["variants"] = variants()
    if "placement" in sections:
        summary["placement"] = placement()
    if "context" in sections:
        summary["context"] = context()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
