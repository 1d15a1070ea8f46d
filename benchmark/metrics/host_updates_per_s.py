"""driver: pose updates a second on the host's clock over the traced run's
untraced stretch (the window less its traced stretch): the updates the
driver integrated over the stretch's seconds, the scans its gate turned
away counting in the time. The same quantity as the end-to-end rate that
the host's clock spreads too widely to hold to a bound (PERF.md); it moves
``update_p95_ms``."""


def read(view):
    host = view.host
    if not host or host["seconds"] <= 0.0:
        return None
    return host["updates"] / host["seconds"]
