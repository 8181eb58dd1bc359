"""Plain reference of op kind ``kselect``: sort the keys, take the k-th.

It reads only the inputs the harness made (the same tensor the port got) and
works everything out again: the keys' order (kbench/keyorder.py) and a plain
``torch.sort``, none of the port's descent. ``dtype`` is the precision it
computes in: the configuration's own for the check, the configuration's
``control_dtype`` for the control, whose answers are cast back.
"""

from __future__ import annotations

import torch

from kbench import gen, keyorder

# Every number compared, with its limit: an exact comparison has the limit 0.
LIMITS = {"mismatched_answers": 0}


class Ref:
    def __init__(self, inputs: dict, config: dict, params: dict, dtype: str):
        x = inputs["x"]
        self.out_dtype = x.dtype
        self.dtype = gen.torch_dtype(dtype)
        self.keys = keyorder.sorted_keys(x if self.dtype == x.dtype else x.to(self.dtype))

    def answer(self, k: int) -> torch.Tensor:
        return keyorder.from_keys(self.keys[k - 1], self.dtype).to(self.out_dtype)


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The numbers of one answer: 1 where its bits differ from the
    reference's."""
    return {"mismatched_answers": int((keyorder.bits_of(got) != keyorder.bits_of(want)).sum())}
