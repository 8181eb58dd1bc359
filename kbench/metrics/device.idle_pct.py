"""``device.idle_pct``: the share of the traced window in which no kernel,
copy or set ran on the device (100 less the union of their intervals over
the window's length)."""

from __future__ import annotations


def read(view):
    if not view.device or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
