"""Seeded inputs, made on the device in a few large calls.

The patterns are those of the port's ``utils/datagen.py`` (frozen here so
that a change there cannot move the benchmark): ``uniform`` integers in
``[low, high]``, the CGM reference's ``rand() % 99999999 + 1``
(``TODO-kth-problem-cgm.c:64-71``), and ``normal`` floats, standard normal
logits. They are drawn with a ``torch.Generator`` on the inputs' device
rather than by NumPy on the host: 2^30 keys drawn on the host and copied
would cost seconds of every run's set-up. The same seed gives the same
inputs on the same kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1  # torch.Generator takes seeds below 2^64; any whole number maps into it

# the dtypes of the configurations the benchmark runs and of those PERF.md lists for later
DTYPES = {"int32": torch.int32, "int64": torch.int64, "float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64, "float8_e4m3fn": torch.float8_e4m3fn}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for (``seed``, ``stream``): streams keep the
    inputs and the queries of one seed apart."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & SEED_MASK) * 1_000_003 + stream) & SEED_MASK)
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """A NumPy generator for the host-side query plan of (``seed``, ``stream``)."""
    return np.random.default_rng([int(seed) & SEED_MASK, stream])


def draw(dist: dict, shape, dtype: torch.dtype, device, g: torch.Generator) -> torch.Tensor:
    """A tensor of ``shape`` drawn from ``dist`` (a configuration's
    ``distribution``)."""
    pattern = dist["pattern"]
    if pattern == "uniform":
        # inclusive bounds, as rand() % (high - low + 1) + low
        return torch.randint(int(dist["low"]), int(dist["high"]) + 1, tuple(shape), generator=g, device=device,
                             dtype=dtype)
    if pattern == "normal":  # standard normal, drawn in float32 or float64 and cast to narrower floats
        wide = dtype if dtype in (torch.float32, torch.float64) else torch.float32
        return torch.randn(tuple(shape), generator=g, device=device, dtype=wide).to(dtype)
    raise ValueError(f"unknown pattern {pattern!r}")
