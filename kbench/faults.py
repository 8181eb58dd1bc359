"""Faults planted under the timed path, for the check's own tests and for
``control.py``: each wraps an op's call so that the run still completes and
only the comparison can tell.

- ``altered``: every answer altered where it is produced (the low bit of its
  first value flipped);
- ``stale``: every call after the first returns the first call's answer, a
  state that never moves;
- ``half``: half of the input left out: a select over the first half of the
  keys, or the first half of each batch's rows answered twice.

A fault across chips (an exchange left out) has no place in a one-card cell.
"""

from __future__ import annotations

import torch

from kbench import keyorder

KINDS = ("altered", "stale", "half")


def _flip_first(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    b = keyorder.bits_of(t).view(-1)
    b[0] ^= 1
    return t


def _altered(out):
    if isinstance(out, tuple):
        return (_flip_first(out[0]), *out[1:])
    return _flip_first(out)


def factory(kind: str, call):
    """A ``call_factory`` for ``harness.run_cell``: the op's ``call`` with the
    fault ``kind`` planted."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}; choose from {KINDS}")

    def make(inputs):
        first = []

        def faulty(inp, q):
            if kind == "altered":
                return _altered(call(inp, q))
            if kind == "stale":
                if not first:
                    first.append(call(inp, q))
                return first[0]
            x = inp["x"]
            if x.dim() == 1:  # keys: select over the first half
                half = x.shape[0] // 2
                return call({**inp, "x": x[:half]}, min(q, half) if isinstance(q, int) else q)
            rows = x.shape[1] // 2  # a ring of batches: each batch's first half, answered twice
            v, i = call({**inp, "x": x[:, :rows]}, q)
            return torch.cat([v, v]), torch.cat([i, i])

        return faulty

    return make
