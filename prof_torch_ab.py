#!/usr/bin/env python3
"""Slam2D and PFSlam2D main-path speed of several checkouts, in turns.

    python3 prof_torch_ab.py ROOT [ROOT ...]

Each ROOT is a directory that holds an ``iris_lama_tpu_torch`` package (a
checkout of the repository, or the package unpacked from ``git archive``
of another commit). The roots run one after another, each in a process of
its own, in the order given — list them as parent, change, change, parent
to compare two commits on one card. Each run replays chip_smoke.py's
phase 5 and phase 8 passes (its ``slam_workload``/``slam_pass`` and
``pf_workload``/``pf_pass``, taken from the chip_smoke.py beside this
script whatever the root), three fresh drivers each, and prints one JSON
line: scans/s and updates/s per pass, with their accuracy.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run_one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    import iris_lama_tpu_torch
    pkg = os.path.dirname(iris_lama_tpu_torch.__file__)
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    # this checkout's chip_smoke.py, not the one a root may hold
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    dev = torch.device("cuda:0")
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    for key, workload, one_pass, rate, acc in (
            ("slam", cs.slam_workload, cs.slam_pass, "scans_per_s", "ate_m"),
            ("pf", cs.pf_workload, cs.pf_pass, "updates_per_s",
             "final_err_m")):
        data, opts, padded = workload()
        staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
                  for p in padded]
        passes = [one_pass(torch, dev, data, opts, staged, p)
                  for p in range(3)]
        out[f"{key}_{rate}"] = [p[rate] for p in passes]
        out[f"{key}_{acc}"] = [p[acc] for p in passes]
        del staged
    return out


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "--one":
        print(json.dumps(run_one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
