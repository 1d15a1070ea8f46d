"""loop closure: candidate searches (``find_candidates`` spans: one a key
pose searched for loops) over the integrated updates of the traced
window. Moves ``update_p95_ms``."""


def read(view):
    if "update" not in view.spans or not view.n_updates:
        return None
    return len(view.spans.get("find_candidates", ())) / view.n_updates
