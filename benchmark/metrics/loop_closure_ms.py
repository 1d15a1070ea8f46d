"""loop closure: host ms an integrated update spends in the ``close_loops``
(candidate search and verification dispatch) and ``harvest`` (the
verification and coarse results read, the acceptance order, the coarse
fallback's dispatch) spans together: their union, since a draining
harvest nests in itself. Moves ``update_p95_ms``."""

from harness.trace import merged


def read(view):
    ivs = view.spans.get("close_loops", []) + view.spans.get("harvest", [])
    if not ivs or not view.n_updates:
        return None
    return sum(e - s for s, e in merged(ivs)) / 1e6 / view.n_updates
