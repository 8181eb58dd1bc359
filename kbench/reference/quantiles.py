"""Plain reference of op kind ``quantiles``: sort the keys, take each
quantile's nearest rank.

The ranks are worked out again from the query's quantiles, as nearest ranks
in float64: ``k = max(1, min(n, ceil(q * n)))``. Otherwise as the
``kselect`` reference: the inputs the port got, a plain ``torch.sort`` of
their keys, and ``dtype`` the precision it computes in.
"""

from __future__ import annotations

import math

import torch

from kbench import gen, keyorder

LIMITS = {"mismatched_answers": 0}


def ranks(qs, n: int) -> list:
    return [max(1, min(n, math.ceil(float(q) * n))) for q in qs]


class Ref:
    def __init__(self, inputs: dict, config: dict, params: dict, dtype: str):
        x = inputs["x"]
        self.n = x.numel()
        self.out_dtype = x.dtype
        self.dtype = gen.torch_dtype(dtype)
        self.keys = keyorder.sorted_keys(x if self.dtype == x.dtype else x.to(self.dtype))

    def answer(self, qs: list) -> torch.Tensor:
        ks = torch.tensor(ranks(qs, self.n), dtype=torch.int64, device=self.keys.device)
        return keyorder.from_keys(self.keys[ks - 1], self.dtype).to(self.out_dtype)


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The numbers of one query: the ranks whose answer's bits differ from
    the reference's."""
    return {"mismatched_answers": int((keyorder.bits_of(got) != keyorder.bits_of(want)).sum())}
