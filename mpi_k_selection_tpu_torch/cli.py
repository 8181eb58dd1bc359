"""Command-line driver: ``python -m mpi_k_selection_tpu_torch``.

The k-th mode of the JAX package's CLI (``cli.py:_run_kth``) on the CUDA
backend::

    # median of 2^30 int32, checked against a NumPy oracle
    python -m mpi_k_selection_tpu_torch --n 1073741824 --verify --json

    # the reference's sequential operating point (k=250) on the CPU
    python -m mpi_k_selection_tpu_torch --n 100000000 --k 250 --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mpi_k_selection_tpu_torch import config
from mpi_k_selection_tpu_torch.utils import datagen
from mpi_k_selection_tpu_torch.utils.timing import ResultRecord, time_fn

DTYPES = (
    "int32",
    "int64",
    "uint32",
    "float32",
    "float64",
    "float16",
    "int16",
    "bfloat16",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_k_selection_tpu_torch",
        description="exact k-selection on a CUDA device (PyTorch port)",
    )
    p.add_argument("--n", type=int, default=1 << 20, help="number of elements")
    p.add_argument(
        "--k", type=int, default=None,
        help="1-indexed rank (default: N/2, the reference's median operating point)",
    )
    p.add_argument("--gen", choices=datagen.PATTERNS, default="uniform")
    p.add_argument("--dtype", choices=DTYPES, default="int32")
    p.add_argument("--seed", type=int, default=config.DEFAULT_SEED)
    p.add_argument("--algorithm", choices=("auto", "radix", "sort"), default="auto")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--verify", action="store_true", help="check against a NumPy oracle")
    p.add_argument("--json", action="store_true", help="emit a JSON result record")
    return p


def oracle(x: np.ndarray, k: int):
    """The k-th smallest of ``x`` in key order (utils/dtypes.py), by
    ``np.partition`` over the keys."""
    from mpi_k_selection_tpu_torch.utils import dtypes as _dt

    keys = _dt.np_to_sortable_bits(x.reshape(-1))
    kth = np.partition(keys, k - 1)[k - 1]
    return _dt.np_from_sortable_bits(np.array([kth]), x.dtype)[0]


def _run_kth(args, x: np.ndarray):
    from mpi_k_selection_tpu_torch.backends import cuda as backend
    from mpi_k_selection_tpu_torch.utils.interop import tensor_from_numpy, tensor_to_numpy

    n = x.size
    k = args.k if args.k is not None else max(1, n // 2)
    if not 1 <= k <= n:
        raise SystemExit(f"error: k={k} out of range [1, {n}]")
    xd = tensor_from_numpy(x, args.device)
    algorithm = backend.plan(n, args.algorithm)
    seconds, answer = time_fn(
        lambda: backend.kselect(xd, k, algorithm=algorithm),
        repeats=args.repeats, warmup=1, device=args.device,
    )
    answer = tensor_to_numpy(answer.reshape(1))[0]
    dev = torch.device(args.device)
    record = ResultRecord(
        answer=answer.item(), n=n, k=k, backend=backend.NAME,
        algorithm=algorithm, dtype=args.dtype, seconds=seconds,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
    )
    ok = True
    if args.verify:
        want = oracle(x, k)
        ok = answer.tobytes() == want.tobytes()  # bit for bit
        record.extra["oracle"] = want.item()
        record.extra["exact_match"] = ok
    return record, ok


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    from mpi_k_selection_tpu_torch.utils.interop import numpy_dtype

    x = datagen.generate(args.n, pattern=args.gen, seed=args.seed, dtype=numpy_dtype(args.dtype))
    try:
        record, ok = _run_kth(args, x)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"error: {e}") from e
    if args.json:
        print(record.to_json())
    else:
        record.print_reference_style()
        if args.verify:
            print(f"oracle check: {'exact match' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
