"""re-org: host ms in the ``reorg`` span (the driver's re-org check, band
scrolls and full flush-and-regathers), summed over the traced window, over
the integrated updates. Rare and long, past the p95; it names
``update_p95_ms``, the end-to-end metric its cells report (PERF.md)."""


def read(view):
    if "reorg" not in view.spans or not view.n_updates:
        return None
    return view.span_total_ns("reorg") / 1e6 / view.n_updates
