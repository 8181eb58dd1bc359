"""Resident-dataset query server: place a dataset once, answer many
queries (counterpart of ``mpi_k_selection_tpu/serve/``).

One long-lived process registers each dataset once (a tensor on a card,
or a replayable chunk source with its resident sketch) and answers
kselect, quantile, top-k and rank-certificate queries from many
concurrent clients:

- **registry** (serve/registry.py): immutable resident datasets by id and
  the keyed program cache (walk closures, cached sorts), so a repeat
  query shape never rebuilds;
- **batcher and lanes** (serve/batcher.py, serve/lanes.py): one
  supervised dispatch lane a device; each lane's bounded coalescing window
  turns concurrent rank queries against a dataset into one shared-pass
  ``kselect_many`` walk, the bits of serial execution;
- **tiers** (serve/tiers.py): ``sketch`` (at once, on the request thread,
  with exact bounds), ``exact`` (the real selection), ``auto`` (the
  sketch when it pins the answer, else exact);
- **http** (serve/http.py): the stdlib JSON-over-HTTP front and
  ``/metrics``; the CLI: ``python -m mpi_k_selection_tpu_torch serve``.
"""

from __future__ import annotations

from mpi_k_selection_tpu_torch.serve.batcher import (
    PendingQuery,
    QueryBatcher,
    SERVE_THREAD_PREFIX,
)
from mpi_k_selection_tpu_torch.serve.errors import (
    DatasetExistsError,
    DatasetNotFoundError,
    DeadlineExceededError,
    DispatchCrashedError,
    QueryError,
    ServeError,
    ServerClosedError,
    ServerOverloadedError,
)
from mpi_k_selection_tpu_torch.serve.http import (
    KSelectHTTPServer,
    start_http_server,
)
from mpi_k_selection_tpu_torch.serve.lanes import LaneDispatcher, lane_key_for
from mpi_k_selection_tpu_torch.serve.registry import (
    DatasetRegistry,
    ProgramCache,
    ResidentDataset,
)
from mpi_k_selection_tpu_torch.serve.server import KSelectServer
from mpi_k_selection_tpu_torch.serve.tiers import TIERS, RankAnswer

__all__ = [
    "DatasetExistsError",
    "DatasetNotFoundError",
    "DatasetRegistry",
    "DeadlineExceededError",
    "DispatchCrashedError",
    "KSelectHTTPServer",
    "KSelectServer",
    "LaneDispatcher",
    "PendingQuery",
    "ProgramCache",
    "QueryBatcher",
    "QueryError",
    "RankAnswer",
    "ResidentDataset",
    "SERVE_THREAD_PREFIX",
    "ServeError",
    "ServerClosedError",
    "ServerOverloadedError",
    "TIERS",
    "lane_key_for",
    "start_http_server",
]
