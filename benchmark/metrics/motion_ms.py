"""PF motion and resample: host ms an integrated update spends in the
``motion`` span (``PFSlam2D._flush_motion``: the odometry packets queued
behind the gate, their normal draws, their copy to the card and the
particles moved; the empty flush of the pose read after the update
included). Moves ``update_p95_ms``."""


def read(view):
    if "motion" not in view.spans or not view.n_updates:
        return None
    return view.span_total_ns("motion") / 1e6 / view.n_updates
