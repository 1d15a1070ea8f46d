"""pose graph: host ms an integrated update spends in the ``optimize``
span (the factor graph's Levenberg-Marquardt and the correction's rebase),
summed over the traced window, over the integrated updates; 0 when no
optimisation ran. Rare and long, past the p95; it names
``update_p95_ms``, the end-to-end metric of its cell."""


def read(view):
    if "update" not in view.spans or not view.n_updates:
        return None
    return view.span_total_ns("optimize") / 1e6 / view.n_updates
