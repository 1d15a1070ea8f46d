"""map update: host ms an integrated update spends in the ``map_update``
span (raycast, deposit B1, occupancy, EDT B3, merge into the resident
grids). Moves ``update_p95_ms``."""


def read(view):
    if "map_update" not in view.spans or not view.n_updates:
        return None
    return view.span_total_ns("map_update") / 1e6 / view.n_updates
