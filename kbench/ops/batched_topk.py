"""Op kind ``batched_topk``: the k largest of every row of a batch, values
and int64 positions, a query.

The inputs are a ring of ``ring`` seeded batches of ``(batch, width)``;
query i reads batch ``i % ring``, so each call reads a batch the last one did
not. The call is ``mpi_k_selection_tpu_torch.batched_topk``.
"""

from __future__ import annotations

import mpi_k_selection_tpu_torch as kt

from kbench import gen, work

KEEP_ALL = False  # a seeded sample of the calls is checked (the cell's check_calls)


def make_inputs(config: dict, params: dict, seed: int, device) -> dict:
    shape = (config["ring"], config["batch"], config["width"])
    x = gen.draw(config["distribution"], shape, gen.torch_dtype(config["dtype"]), device,
                 gen.generator(seed, device))
    return {"x": x, "k": params["k"]}


class Plan:
    def __init__(self, config: dict, params: dict, seed: int):
        self.ring = config["ring"]

    def query(self, i: int) -> int:
        return i % self.ring

    def warm(self) -> list:
        return list(range(self.ring))


def call(inputs: dict, r: int):
    return kt.batched_topk(inputs["x"][r], inputs["k"])


def dispatch(inputs: dict, r: int) -> str:
    """The leg the port takes: ``block`` where the call launched row 7's
    kernel (its launch book moved), ``flat`` (a row sort) otherwise."""
    from mpi_k_selection_tpu_torch.ops.cuda import topk as block

    before = sum(block.LAUNCHES.values())
    call(inputs, r)
    return "block" if sum(block.LAUNCHES.values()) > before else "flat"


def least_bytes(config: dict, params: dict) -> int:
    return work.topk_bytes(config["batch"], config["width"], params["k"], gen.torch_dtype(config["dtype"]).itemsize)
