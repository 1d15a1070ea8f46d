"""driver: the host's calls into the CUDA runtime or driver that wait on
the device (stream, event, context and device synchronisations, and
blocking copies), counted in the traced window, over the integrated
updates. A device-to-host read is a copy and a stream synchronisation; it
counts once, as its wait. Moves ``update_p95_ms``."""

BLOCKING_COPIES = ("cudaMemcpy", "cudaMemcpy2D", "cuMemcpyDtoH_v2",
                   "cuMemcpyHtoD_v2", "cuMemcpy")


def read(view):
    if not view.runtime or not view.n_updates:
        return None
    n = sum(1 for name, _, _ in view.runtime
            if "Synchronize" in name or name in BLOCKING_COPIES)
    return n / view.n_updates
