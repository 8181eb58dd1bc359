"""Plain reference of op kind ``batched_topk``: every row's k largest, in the
keys' order, ties by ascending position.

Each element's key (kbench/keyorder.py) and its position fold into one
int64, ``key * 2^s + (width - 1 - position)``, unique within a row, so a
plain ``torch.topk`` over it has no ties to order and its k largest are the
answer: the values decoded from the keys, the positions from the low bits.
None of the port's kernels or sort paths is used. ``dtype`` is the precision
it computes in (the batch cast to it; the values cast back).
"""

from __future__ import annotations

import torch

from kbench import gen, keyorder

LIMITS = {"value_mismatches": 0, "position_mismatches": 0}


class Ref:
    def __init__(self, inputs: dict, config: dict, params: dict, dtype: str):
        self.x = inputs["x"]
        self.k = inputs["k"]
        self.dtype = gen.torch_dtype(dtype)
        self.batches: dict = {}

    def _topk(self, xb: torch.Tensor):
        width = xb.shape[-1]
        s = max(1, (width - 1).bit_length())
        xs = xb if xb.dtype == self.dtype else xb.to(self.dtype)
        pos = torch.arange(width, device=xb.device, dtype=torch.int64)
        folded = keyorder.to_keys(xs).to(torch.int64) * (1 << s) + (width - 1 - pos)
        top = torch.topk(folded, self.k, dim=-1, largest=True, sorted=True).values
        del folded
        values = keyorder.from_keys(top >> s, self.dtype).to(xb.dtype)
        return values, width - 1 - (top & ((1 << s) - 1))

    def answer(self, r: int):
        if r not in self.batches:
            self.batches[r] = self._topk(self.x[r])
        return self.batches[r]


def compare(got, want) -> dict:
    """The numbers of one call: the (row, slot) entries whose value bits, and
    whose positions, differ from the reference's."""
    (gv, gi), (wv, wi) = got, want
    return {"value_mismatches": int((keyorder.bits_of(gv) != keyorder.bits_of(wv)).sum()),
            "position_mismatches": int((gi != wi).sum())}
