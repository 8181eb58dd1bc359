"""Op kind ``kselect``: one exact k-th smallest of a resident array a query.

The query is the rank k. The cell's ``first_ks`` come first (an integer is a
rank, ``{"n_over": d}`` is ``n // d``); then k is drawn uniformly from
``[1, n]`` by the seed. The call is ``mpi_k_selection_tpu_torch.kselect``.
"""

from __future__ import annotations

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.obs import Observability
from mpi_k_selection_tpu_torch.obs.events import ListSink

from kbench import gen, work

KEEP_ALL = True  # every answer is checked: one scalar a query
PLAN_SIZE = 1 << 16  # drawn ranks; a window cycles them if it runs longer


def make_inputs(config: dict, params: dict, seed: int, device) -> dict:
    x = gen.draw(config["distribution"], (config["n"],), gen.torch_dtype(config["dtype"]), device,
                 gen.generator(seed, device))
    return {"x": x}


def _rank(spec, n: int) -> int:
    return n // int(spec["n_over"]) if isinstance(spec, dict) else int(spec)


class Plan:
    def __init__(self, config: dict, params: dict, seed: int):
        n = config["n"]
        self.first = [_rank(s, n) for s in params.get("first_ks", [])]
        self.drawn = gen.host_rng(seed, 1).integers(1, n + 1, size=PLAN_SIZE).tolist()
        self.warm_ks = self.first + gen.host_rng(seed, 2).integers(1, n + 1, size=2).tolist()

    def query(self, i: int) -> int:
        if i < len(self.first):
            return self.first[i]
        return self.drawn[(i - len(self.first)) % PLAN_SIZE]

    def warm(self) -> list:
        return self.warm_ks


def call(inputs: dict, k: int):
    return kt.kselect(inputs["x"], k)


def dispatch(inputs: dict, k: int) -> str:
    """The leg the port takes for this query (its ``resident.select``
    event)."""
    obs = Observability(events=ListSink())
    kt.kselect(inputs["x"], k, obs=obs)
    return obs.events.events[-1].algorithm


def least_bytes(config: dict, params: dict) -> int:
    return work.select_query_bytes(config["n"], gen.torch_dtype(config["dtype"]).itemsize)
