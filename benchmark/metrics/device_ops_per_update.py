"""device: device activities (kernels, copies, fills) in the traced
window over the integrated updates: the launches each update costs the
host. Moves ``update_p95_ms``."""


def read(view):
    if not view.device or not view.n_updates:
        return None
    return len(view.device) / view.n_updates
