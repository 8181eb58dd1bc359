"""``descent.host_reads``: the descent's population reads to the host a
query, as the port counts them: its ``ksel.descent.host_read`` spans in the
traced window over the queries. It sits beside ``descent.host_syncs``, the
device-to-host copies the trace saw. A program that emits no ``ksel.`` span
reads nothing.
"""

from __future__ import annotations

from kbench import spans as sp


def read(view):
    spans = sp.in_window(view)
    if not spans or view.queries <= 0:
        return None
    return sum(e.name == sp.HOST_READ for e in spans) / view.queries
