"""Typed errors of the resident-dataset query server (serve/), the JAX
package's classes with the same names, bases and ``retry_after``.

The HTTP front maps each class to a status code (a registry miss is a
404, a malformed query a 400, a closed server a 503, an expired deadline a
504, a shed query a 503 with ``Retry-After``), and an embedding caller
catches exactly the case it can handle. All inherit :class:`ServeError`,
so "anything the server raised" is one except clause.
"""

from __future__ import annotations


class ServeError(RuntimeError):
    """Base class of every serving-layer error."""


class DatasetNotFoundError(ServeError):
    """No dataset is registered under the requested id (HTTP 404)."""


class DatasetExistsError(ServeError):
    """A dataset id was registered twice. Resident data is immutable:
    replacing it under a live id would race in-flight queries; drop the id
    first, then add the new data."""


class QueryError(ServeError, ValueError):
    """A malformed or unanswerable query: an unknown tier or op, a rank or
    quantile out of range, the sketch tier on a dataset without a resident
    sketch, top-k on a stream dataset (HTTP 400)."""


class ServerClosedError(ServeError):
    """The server (or its dispatch lane) is closed: no further query is
    taken, and queued ones fail with this (HTTP 503)."""


class DeadlineExceededError(ServeError):
    """The request's deadline expired before its answer came (HTTP 504):
    raised on the request thread when the wait times out, and set by the
    dispatch thread when it drops an already-expired query unrun."""


class ServerOverloadedError(ServeError):
    """Admission control shed this query: the lane's dispatch queue is at
    its depth bound (HTTP 503 with ``Retry-After``). ``retry_after`` is the
    suggested client backoff in seconds."""

    def __init__(self, message: str, *, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = float(retry_after)


class DispatchCrashedError(ServeError):
    """A lane's dispatch loop crashed while this query was in flight; its
    supervisor restarted the loop (``serve.dispatch_restarts``) and failed
    only the in-flight batch with this (HTTP 500)."""
