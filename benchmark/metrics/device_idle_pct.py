"""device: the share of the traced window, in percent, that no device
activity (kernel, copy, fill) covers, on the trace's own timeline. Moves
``update_p95_ms`` (PERF.md)."""


def read(view):
    if not view.device or view.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
