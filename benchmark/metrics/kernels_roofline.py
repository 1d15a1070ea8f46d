"""kernels: the port's hand-written kernels' share of their roofline in
the traced window, in percent: the sum of their calls' bounds over the sum
of their device time. A kernel counts when ``benchmark/roofline/`` holds
its counts and the driver names the shapes of its calls; a call's bound is
the larger of its bytes over the HBM bandwidth and its operations over the
float32 rate (``harness/peaks.py``). Moves ``update_p95_ms``."""

from harness import peaks, spec
from harness.trace import kernel_base


def read(view):
    bound_us = device_us = 0.0
    per_call = {}
    for name, s, e in view.device:
        base = kernel_base(name)
        if base not in per_call:
            call = view.kernel_calls.get(base)
            per_call[base] = (
                peaks.bound_us(*spec.load_module("roofline", base)
                               .counts(call))
                if call is not None and spec.has_module("roofline", base)
                else None)
        if per_call[base] is None:
            continue
        bound_us += per_call[base]
        device_us += (e - s) / 1e3
    if device_us <= 0.0:
        return None
    return 100.0 * bound_us / device_us
