#!/usr/bin/env python3
"""Probe of the sweep kernel's order-free route (``csrc/sweep_ingest.cu``)
on one CUDA card: ``python3 mpi_k_selection_tpu_torch/probes/sweep_probe.py``
from the root of the repository.

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

Prints the card's name and power limit first and a JSON summary last.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mpi_k_selection_tpu_torch.ops.cuda import build  # noqa: E402
from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S  # noqa: E402
from mpi_k_selection_tpu_torch.utils import datagen  # noqa: E402

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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_probe: no CUDA device; this probe runs only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.build_all(["sweep_ingest"])
    probe = build_probe()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    summary = {"device": smi, "loads": loads(probe, sms), "copies": copies()}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
