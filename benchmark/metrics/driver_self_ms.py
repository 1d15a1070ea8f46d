"""driver: host ms an integrated update spends in the driver's ``update``
span outside every other span (the gate, the odometry, the scan's padding
and copy to the card, the host reads between layers). Moves
``update_p95_ms``."""

from harness.trace import WINDOW, clip, merged


def read(view):
    outer = view.spans.get("update")
    if not outer or not view.n_updates:
        return None
    inner = merged([iv for name, ivs in view.spans.items()
                    if name not in ("update", WINDOW) for iv in ivs])
    self_ns = 0
    for s, e in outer:
        self_ns += (e - s) - sum(b - a for a, b in clip(inner, s, e))
    return self_ns / 1e6 / view.n_updates
