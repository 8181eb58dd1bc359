"""Op kind ``quantiles``: a table of nearest-rank quantiles of a resident
array a query.

The table is ``start + j * step`` for ``j < count``; each query shifts the
whole table by an offset drawn by the seed from ``[0, shift_max)``, so no two
queries ask for the same ranks. The call is
``mpi_k_selection_tpu_torch.quantiles`` (``kselect_many`` underneath).
"""

from __future__ import annotations

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.obs import Observability
from mpi_k_selection_tpu_torch.obs.events import ListSink

from kbench import gen, work

KEEP_ALL = True  # every answer is checked: one small row a query
PLAN_SIZE = 1 << 14


def make_inputs(config: dict, params: dict, seed: int, device) -> dict:
    x = gen.draw(config["distribution"], (config["n"],), gen.torch_dtype(config["dtype"]), device,
                 gen.generator(seed, device))
    return {"x": x}


class Plan:
    def __init__(self, config: dict, params: dict, seed: int):
        t = params["table"]
        self.table = [t["start"] + j * t["step"] for j in range(t["count"])]
        self.shifts = gen.host_rng(seed, 1).uniform(0.0, params["shift_max"], size=PLAN_SIZE).tolist()
        self.warm_shifts = gen.host_rng(seed, 2).uniform(0.0, params["shift_max"], size=2).tolist()

    def _qs(self, shift: float) -> list:
        return [q + shift for q in self.table]

    def query(self, i: int) -> list:
        return self._qs(self.shifts[i % PLAN_SIZE])

    def warm(self) -> list:
        return [self._qs(s) for s in self.warm_shifts]


def call(inputs: dict, qs: list):
    return kt.quantiles(inputs["x"], qs)


def dispatch(inputs: dict, qs: list) -> str:
    obs = Observability(events=ListSink())
    kt.quantiles(inputs["x"], qs, obs=obs)
    return obs.events.events[-1].algorithm


def least_bytes(config: dict, params: dict) -> int:
    return work.select_query_bytes(config["n"], gen.torch_dtype(config["dtype"]).itemsize, params["table"]["count"])
