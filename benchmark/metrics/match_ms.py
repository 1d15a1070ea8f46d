"""scan match: host ms an integrated update spends in the ``match`` span
(the driver's scan match: Slam2D's IRLS with B2, the PF's batched solve
B6). Moves ``update_p95_ms``."""


def read(view):
    if "match" not in view.spans or not view.n_updates:
        return None
    return view.span_total_ns("match") / 1e6 / view.n_updates
