"""map publication: host ms an integrated update spends in the ``publish``
span (``generate_occupancy_map``: the drain of pending key events and
verifications, the rebuild B1 pair and B3 over every key scan, the pool
packed), summed over the traced window, over the integrated updates; 0
when no publication fell in it. Past the p95 (one update in 200); it
names ``update_p95_ms``, the end-to-end metric of its cell."""


def read(view):
    if "update" not in view.spans or not view.n_updates:
        return None
    return view.span_total_ns("publish") / 1e6 / view.n_updates
