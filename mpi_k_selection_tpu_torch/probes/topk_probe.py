#!/usr/bin/env python3
# ksel-torch: noqa-file[KSL009] -- a command-line probe: its printed lines are its report
"""Probe of ``batched_topk`` on one CUDA card, for timing one commit beside
another in one call: ``python3 mpi_k_selection_tpu_torch/probes/topk_probe.py
[--package DIR]`` from the root of the repository.

At float32 k=8, float32 k=16 and bfloat16 k=8, on (4096, 32768) normal
rows and ``chip_smoke.py``'s adversarial rows: ``batched_topk`` of the
package in use (values and indices) end to end, its launches and its peak
device memory above the input; the kernel alone through the package's
wrappers (``ops.cuda.topk.batched_topk`` where the package has it, and
``batched_topk_values``); ``torch.topk(dim=-1)`` beside. ``--package DIR``
imports ``mpi_k_selection_tpu_torch`` from the checkout at DIR (another
commit's package, built in its own ``_build/``), so that one call can time
parent, change, change, parent. Prints the card's name and power limit
first and a JSON summary last.
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

TIMED = (("float32 k=8", torch.float32, 8), ("float32 k=16", torch.float32, 16), ("bfloat16 k=8", torch.bfloat16, 8))


def datasets(gen) -> dict:
    x = torch.randn((cs.BATCH, cs.WIDTH), device="cuda", generator=gen)
    adv = cs.adversarial_rows(x, gen)
    return {
        ("normal", torch.float32): x, ("normal", torch.bfloat16): x.to(torch.bfloat16),
        ("adversarial", torch.float32): adv, ("adversarial", torch.bfloat16): cs.bf16_truncated(adv),
    }


def e2e(data: dict) -> list:
    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch.ops.cuda import topk as T

    rows = []
    for what, dtype, k in TIMED:
        for label in ("normal", "adversarial"):
            x = data[(label, dtype)]
            kt.batched_topk(x, k)
            torch.cuda.synchronize()
            T.reset_counts()
            kt.batched_topk(x, k)
            torch.cuda.synchronize()
            launches = {n: c for n, c in T.LAUNCHES.items() if c}
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kt.batched_topk(x, k)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = cuda_ms(lambda: kt.batched_topk(x, k), iters=20, warmup=3)
            row = {"what": what, "rows": label, "ms": ms, "launches": launches, "peak_bytes": peak}
            for name in ("batched_topk", "batched_topk_values"):
                if hasattr(T, name):
                    fn = getattr(T, name)
                    row[f"kernel {name} ms"] = cuda_ms(lambda: fn(x, k), iters=50, warmup=5)
            rows.append(row)
            kernels = "; ".join(f"{n} {v:.4f} ms" for n, v in row.items() if n.startswith("kernel "))
            print(f"[e2e] batched_topk {what} {label}: {ms:.4f} ms; launches {launches}; peak above the input "
                  f"{peak / 2**20:.2f} MiB; {kernels}")
        tms = cuda_ms(lambda: torch.topk(data[("normal", dtype)], k, dim=-1), iters=20, warmup=3)
        rows.append({"what": what, "rows": "normal", "torch_topk_ms": tms})
        print(f"[e2e] torch.topk(dim=-1) {what}: {tms:.4f} ms")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("topk_probe: no CUDA device; this probe runs only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    args = sys.argv[1:]
    if "--package" in args:
        at = args.index("--package")
        del args[at:at + 2]
    if args:
        raise SystemExit(f"topk_probe: unknown arguments {args}")
    data = datasets(torch.Generator(device="cuda").manual_seed(0))
    print(json.dumps({"device": smi, "e2e": e2e(data)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
