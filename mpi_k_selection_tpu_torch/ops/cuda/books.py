"""The kernel wrappers' books: ``LAUNCHES`` (kernel launches) and
``PLAIN_CALLS`` (plain versions' calls), and the launch trail.

A :class:`Book` is a dict of counts. Each increment is also appended, by
name, to every armed :func:`launch_trail`: the sequence of launches (or
plain calls) a piece of code makes, which the analyzer's KSC103 contract
compares across batch sizes (analysis/contracts.py).
"""

from __future__ import annotations

import contextlib

_ARMED: list[list[str]] = []  # the armed trails, innermost last


class Book(dict):
    """Counts by kernel name; increments feed the armed trails."""

    def __setitem__(self, name, value):
        if _ARMED and value > self.get(name, 0):
            for trail in _ARMED:
                trail.append(name)
        super().__setitem__(name, value)


@contextlib.contextmanager
def launch_trail():
    """Record, in order, the name of every book increment made inside the
    block (every launch and plain call of every wrapper) into the list it
    yields."""
    trail: list[str] = []
    _ARMED.append(trail)
    try:
        yield trail
    finally:
        _ARMED.remove(trail)
