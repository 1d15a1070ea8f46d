"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Builds what the program's kernel cache lacks
(``build/torch_kernels/`` in the checkout), makes the cell's lap from the
seed on the card, builds the driver, warms up, then hands the scan stream
to the driver for ``--seconds`` (``--trace 1``: its last stretch, the
traffic file's ``trace_seconds`` at most, under torch.profiler, with
spans; the rest untraced, for the host clock's readings). Then it
checks what the program produced against the plain reference and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (``busy_s`` and
``window_s`` when traced), ``breakdown`` (traced) and ``checks``, each
number compared beside its limit; the same numbers are the last lines of
standard error.

Exits 2, printing no result, without a CUDA device (or fewer than the cell
asks for), and 3 when the process holds JAX or the JAX package once the
window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# the benchmark's own modules, then the checkout's root, where the program
# (``iris_lama_tpu_torch``) lives
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

FORBIDDEN = ("jax", "jaxlib", "flax", "iris_lama_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``iris_lama_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What the end-to-end metrics read."""

    setup_s: float
    latency_s: list
    start: float
    end: float

    @property
    def n_updates(self) -> int:
        return len(self.latency_s)


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Measured:
    """A cell's run up to the close of its window: the timings, the trace,
    the published updates, and the program's outputs for the check."""

    run: Run
    view: object          # trace.TraceView, or None untraced
    record: list          # window.Update of every integrated update
    lap: object           # traffic.Lap
    outputs: dict         # the driver's outputs (its map)
    peak: int             # bytes, the device's peak


def measure(cell: dict, seed: int, seconds: float, trace: bool, device,
            t0: float) -> Measured:
    """Set up, warm up and measure one cell; then read the program's
    outputs and free its state."""
    import torch
    from harness import spec, traffic as traffic_mod, trace as trace_mod
    from harness.window import timed, warm_up

    torch.set_num_threads(2)
    config, traffic = cell["config"], cell["traffic"]
    if device.type == "cuda":
        from iris_lama_tpu_torch.ops import _cuda
        _cuda.build_all()
        torch.zeros((), device=device)      # the context, then the peak
        torch.cuda.reset_peak_memory_stats(device)
    driver = spec.load_module("drivers", config["driver"])
    lap = traffic_mod.make_lap(traffic, config["sensor"], seed, device)
    clouds = [driver.Node.cloud(p) for p in lap.points]
    node = driver.Node(config, seed, device, lap.poses[0])
    stream = traffic_mod.Stream(lap)
    record = []
    warm_up(node, clouds, stream, traffic["warmup"], record, 20 * lap.n)
    _sync(torch, device)
    # what set-up made lives on: out of the collector's way
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    view, host = None, None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        traced = min(seconds, traffic["trace_seconds"])
        pre = {"latency_s": []}
        if seconds > traced:
            # the window's first part runs untraced: the host clock's
            # readings of the traced run
            pre = timed(node, clouds, stream, seconds - traced, record)
            host = {"updates": len(pre["latency_s"]),
                    "seconds": pre["end"] - pre["start"]}
        first = len(record)
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        restore = trace_mod.install_spans(driver.SPANS)
        if hasattr(node, "start_trace"):
            node.start_trace()
        try:
            with profile(activities=acts) as prof:
                with record_function(trace_mod.WINDOW):
                    res = timed(node, clouds, stream, traced, record,
                                len(pre["latency_s"]))
                    _sync(torch, device)
        finally:
            restore()
            if hasattr(node, "stop_trace"):
                node.stop_trace()
        res["start"] = pre.get("start", res["start"])
        res["latency_s"] = pre["latency_s"] + res["latency_s"]
    else:
        res = timed(node, clouds, stream, seconds, record)
    _sync(torch, device)
    run = Run(setup_s, res["latency_s"], res["start"], res["end"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if trace:
        stretch = record[first:]
        view = trace_mod.reduce(
            prof, driver.SPANS, len(stretch),
            node.kernel_calls(lap, stretch), host)
        del prof
    # once the window has closed and the peak is read: the program's
    # outputs, then its state freed before the reference runs
    outputs = node.outputs()
    del node
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Measured(run, view, record, lap, outputs, int(peak))


def check(cell: dict, m: Measured, seed: int, device) -> dict:
    """Each number the reference compares, beside its limit."""
    from harness import spec
    config = cell["config"]
    reference = spec.load_module("reference", config["driver"])
    limits = config["check"]["limits"]
    got = reference.numbers(m.lap, m.record, m.outputs, config, seed, device)
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in got.items()}


def result(cell: dict, m: Measured, checks: dict, device) -> dict:
    """The result line's object."""
    import torch
    from harness import spec, trace as trace_mod
    metrics = {}
    if m.view is not None:
        for e in cell["per_layer"]:
            v = spec.load_module("metrics", e["name"]).read(m.view)
            if v is not None:
                metrics[e["name"]] = {"value": float(v), "unit": e["unit"]}
    else:
        for e in cell["end_to_end"]:
            v = spec.load_module("metrics", e["name"]).measure(m.run)
            metrics[e["name"]] = {"value": float(v), "unit": e["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["workload"]["chips"]),
           "memory_peak_bytes": m.peak}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": m.run.n_updates, "failed": 0,
           "metrics": metrics, "device": dev}
    if m.view is not None:
        dev["busy_s"] = m.view.busy_s
        dev["window_s"] = m.view.window_s
        out["breakdown"] = trace_mod.breakdown(m.view)
    out["checks"] = checks
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """One run of a cell: the result line's object (without the check for
    JAX in the process)."""
    m = measure(cell, seed, seconds, trace, device, t0)
    return result(cell, m, check(cell, m, seed, device), device)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from harness import spec
    try:
        cell = spec.cell(spec.load_spec(), args.workload)
    except (spec.SpecError, OSError, KeyError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    want = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"benchmark: needs {want} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda:0"), T0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)} once the "
              "window has closed", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
