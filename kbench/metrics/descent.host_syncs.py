"""``descent.host_syncs``: device-to-host copies in the traced window, a
query. Each is a host read that waits for the device (the descent's rung
and walk reads; the harness itself copies nothing back in the window, it
waits on an event)."""

from __future__ import annotations


def read(view):
    if not view.device or view.queries <= 0:
        return None
    return len(view.dtoh_copies()) / view.queries
