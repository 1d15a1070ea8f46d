"""Find what a cell needs by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
files behind the names:

- ``benchmark/configs/<config>.json`` (the configuration entry's ``file``):
  the driver's options, the sensor, the check's sample count and limits;
- ``benchmark/traffic/<traffic>.json``: the world, the route, the motion,
  the noise, the warm-up and the traced stretch;
- ``benchmark/drivers/<driver>.py``: builds the program's driver, lists the
  functions it wraps in spans, and hands its outputs to the check;
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric;
- ``benchmark/roofline/<kernel>.py``: bytes and operations of a kernel;
- ``benchmark/reference/<driver>.py``: the plain reference and the check.

Python files are loaded by path under a private module name, so no name of
this folder can shadow an installed package.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


class SpecError(RuntimeError):
    """A name that the benchmark's files do not define."""


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_spec(path: Path = SPEC_FILE) -> dict:
    if not path.exists():
        raise SpecError(f"{path} is missing")
    return load_json(path)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(spec: dict, workload: str) -> dict:
    """The resolved cell: its entry, configuration entry and both files,
    and the metrics it reports in a run without and with the trace."""
    w = _named(spec["workloads"], workload, "workload")
    centry = _named(spec["configs"], w["config"], "configuration")
    config = load_json(ROOT / centry["file"])
    traffic_path = BENCH_DIR / "traffic" / f"{w['traffic']}.json"
    if not traffic_path.exists():
        raise SpecError(f"no traffic file {traffic_path}")
    return {
        "workload": w,
        "config_entry": centry,
        "config": config,
        "traffic": load_json(traffic_path),
        "end_to_end": metrics_for(spec["end_to_end"], workload),
        "per_layer": metrics_for(spec["per_layer"], workload),
    }


def metrics_for(entries: list, workload: str) -> list:
    """The metrics a cell reports: those that list it under ``workloads``
    and those that list no cells at all."""
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (cached per process)."""
    path = BENCH_DIR / kind / f"{name}.py"
    key = f"_lama_bench_{kind}_{name}"
    if key in sys.modules:
        return sys.modules[key]
    if not path.exists():
        raise SpecError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def has_module(kind: str, name: str) -> bool:
    return (BENCH_DIR / kind / f"{name}.py").exists()
