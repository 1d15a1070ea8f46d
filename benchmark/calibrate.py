"""Readings that the check's limits are set from: the program's numbers
over many seeds, the control's (the plain reference in the program's
place, computed in a lower precision), and the numbers of faults planted
in the program. Not part of the benchmark's runs.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 10 [--control] [--faults]

One process: each seed sets up, warms up and runs the cell's window at its
own load, then the check's numbers are read for the program and, with
``--control``, for the control (``bfloat16``; the port's arithmetic has no
matrix product or convolution, so TF32 would compute the same numbers),
and with ``--faults`` the run is repeated with each of the driver file's
``FAULTS`` planted. Prints one JSON line a reading, and writes them to
``chiprun_out/calibrate_<workload>.jsonl``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import run as bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from harness import spec
    cell = spec.cell(spec.load_spec(), args.workload)
    config = cell["config"]
    driver = spec.load_module("drivers", config["driver"])
    reference = spec.load_module("reference", config["driver"])
    device = torch.device("cuda:0")
    out_dir = os.path.join(os.path.dirname(BENCH_DIR), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    log = open(os.path.join(out_dir, f"calibrate_{args.workload}.jsonl"),
               "a", encoding="utf-8")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    kinds = [None] + (sorted(driver.FAULTS) if args.faults else [])
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in kinds:
            undo = driver.FAULTS[fault]() if fault else None
            try:
                t0 = time.perf_counter()
                m = bench.measure(cell, seed, args.seconds, False, device,
                                  t0)
            finally:
                if undo:
                    undo()
            t1 = time.perf_counter()
            nums = reference.numbers(m.lap, m.record, m.outputs, config,
                                     seed, device)
            emit({"seed": seed, "kind": fault or "program",
                  "updates": m.run.n_updates,
                  "rate": m.run.n_updates / (m.run.end - m.run.start),
                  "setup_s": m.run.setup_s, "check_s": time.perf_counter() - t1,
                  "numbers": nums})
            if args.control and fault is None:
                t1 = time.perf_counter()
                nums = reference.numbers(m.lap, m.record, m.outputs, config,
                                         seed, device, dtype=torch.bfloat16)
                emit({"seed": seed, "kind": "control_bf16",
                      "check_s": time.perf_counter() - t1, "numbers": nums})
            del m
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
