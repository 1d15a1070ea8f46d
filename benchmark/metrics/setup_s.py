"""Set-up: seconds from the start of the process to the first timed scan
(imports, kernel build or load, the lap's generation, the driver's
construction, the warm-up)."""


def measure(run):
    return run.setup_s
