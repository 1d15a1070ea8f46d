"""Whole runs of each cell on the CPU at a cut size (a few warm-up
updates, a window of a second or two, three sampled updates): the last
line's shape, the program's CPU path against the plain reference, the
control and each planted fault failing the check, and the guards."""

import copy
import sys
import time

import pytest
import torch

import run as bench
from harness import spec

CPU = torch.device("cpu")
SEED = 2 ** 33 + 17


def cut(workload: str) -> dict:
    cell = copy.deepcopy(spec.cell(spec.load_spec(), workload))
    cell["traffic"]["warmup"] = {"updates": 5, "reorgs": 0}
    cell["traffic"]["trace_seconds"] = 1.0
    check = cell["config"]["check"]
    check["samples"] = min(check["samples"], 3)
    if "sample_from" in check:          # updates copied for the check
        check["samples"] = 1
        check["sample_from"] = 2
        check["reorg_samples"] = 0
    return cell


def workloads():
    return [w["name"] for w in spec.load_spec()["workloads"]]


@pytest.fixture(scope="module", params=workloads())
def measured(request):
    cell = cut(request.param)
    m = bench.measure(cell, SEED, 4.0, False, CPU, time.perf_counter())
    return cell, m


def test_the_last_line_has_the_contract_shape(measured):
    cell, m = measured
    out = bench.result(cell, m, bench.check(cell, m, SEED, CPU), CPU)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    want = {e["name"]: e["unit"] for e in cell["end_to_end"]}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["attempted"] == m.run.n_updates > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(cell["config"]["check"]["limits"])


def test_the_traced_line_carries_busy_window_and_breakdown():
    cell = cut(workloads()[0])
    # a second untraced, then the traced second
    out = bench.run_cell(cell, SEED + 1, 2.0, True, CPU, time.perf_counter())
    assert list(out)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {e["name"] for e in cell["per_layer"]}
    # the CPU has no device trace: only the spans' metrics are read
    assert set(out["metrics"]) <= per_layer
    assert {"match_ms", "map_update_ms",
            "host_updates_per_s"} <= set(out["metrics"])
    assert out["attempted"] > out["metrics"]["host_updates_per_s"]["value"]


def test_the_cpu_path_agrees_with_the_plain_reference(measured):
    cell, m = measured
    checks = bench.check(cell, m, SEED, CPU)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert checks["map_counts_differ"]["value"] == 0.0
    assert checks["map_dist_differ"]["value"] == 0.0


def test_the_control_fails_the_check(measured):
    cell, m = measured
    ref = spec.load_module("reference", cell["config"]["driver"])
    got = ref.numbers(m.lap, m.record, m.outputs, cell["config"], SEED, CPU,
                      dtype=torch.bfloat16)
    limits = cell["config"]["check"]["limits"]
    assert [k for k, v in got.items() if v > limits[k]], got


def _faults():
    out = []
    for w in workloads():
        driver = spec.cell(spec.load_spec(), w)["config"]["driver"]
        out += [(w, f) for f in sorted(spec.load_module("drivers",
                                                        driver).FAULTS)]
    return out


@pytest.mark.parametrize("workload,fault", _faults())
def test_a_planted_fault_fails_the_check(workload, fault):
    cell = cut(workload)
    driver = spec.load_module("drivers", cell["config"]["driver"])
    undo = driver.FAULTS[fault]()
    try:
        m = bench.measure(cell, SEED + 2, 0.4, False, CPU,
                          time.perf_counter())
    finally:
        undo()
    out = bench.result(cell, m, bench.check(cell, m, SEED + 2, CPU), CPU)
    assert out["correct"] is False, out["checks"]


def test_no_result_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench.main(["--workload", workloads()[0], "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_an_unknown_workload_prints_no_result(capsys):
    assert bench.main(["--workload", "nothing.here", "--seed", "1",
                       "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    assert bench.forbidden_modules() == []
    import iris_lama_tpu_torch  # noqa: F401  (its name starts alike)
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "iris_lama_tpu.algos", object())
    assert bench.forbidden_modules() == ["iris_lama_tpu", "jaxlib"]


@pytest.mark.gpu
def test_a_run_on_the_card(cuda_device):
    cell = cut(workloads()[0])
    out = bench.run_cell(cell, SEED, 2.0, False, cuda_device,
                         time.perf_counter())
    assert out["correct"] and out["device"]["platform"] == "gpu"
