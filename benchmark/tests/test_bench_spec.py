"""Lookup by name, the frozen counts, the routes and the import rule."""

import ast
import json
import math
import os

import numpy as np
import pytest

from harness import peaks, spec, traffic as traffic_mod
from harness.trace import TraceView, kernel_base, merged

BENCH = spec.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "iris_lama_tpu"}


def test_every_cell_resolves_by_name():
    s = spec.load_spec()
    for w in s["workloads"]:
        cell = spec.cell(s, w["name"])
        config = cell["config"]
        assert spec.has_module("drivers", config["driver"])
        assert spec.has_module("reference", config["driver"])
        assert cell["end_to_end"] and cell["per_layer"]
        for m in cell["end_to_end"]:
            assert hasattr(spec.load_module("metrics", m["name"]), "measure")
        for m in cell["per_layer"]:
            assert hasattr(spec.load_module("metrics", m["name"]), "read")
        limits = config["check"]["limits"]
        assert limits and all(v >= 0 for v in limits.values())


def test_unknown_names_are_refused():
    s = spec.load_spec()
    with pytest.raises(spec.SpecError):
        spec.cell(s, "no.such_cell")
    with pytest.raises(spec.SpecError):
        spec.load_module("metrics", "no_such_metric")


def test_metrics_follow_their_workloads_key():
    entries = [{"name": "a"}, {"name": "b", "workloads": ["x"]}]
    assert [m["name"] for m in spec.metrics_for(entries, "x")] == ["a", "b"]
    assert [m["name"] for m in spec.metrics_for(entries, "y")] == ["a"]


def test_the_harness_names_no_cell_config_or_metric():
    s = spec.load_spec()
    names = ({w["name"] for w in s["workloads"]}
             | {c["name"] for c in s["configs"]}
             | {m["name"] for m in s["end_to_end"] + s["per_layer"]})
    code = "".join(open(os.path.join(BENCH, "harness", f)).read()
                   for f in os.listdir(os.path.join(BENCH, "harness"))
                   if f.endswith(".py"))
    code += open(os.path.join(BENCH, "run.py")).read()
    assert not [n for n in names if f'"{n}"' in code or f"'{n}'" in code]


def test_frozen_counts_against_hand_counts():
    dep = spec.load_module("roofline", "deposit_kernel")
    # 2 hits and 3 free cells into 2 grids of 4 x 5 int32 cells
    assert dep.counts({"particles": 1, "hits": 2, "free": 3, "h": 4,
                       "w": 5}) == (5 * 8 + 2 * 20 * 4, 2 * 2 + 3)
    assert dep.counts({"particles": 3, "hits": 2, "free": 3, "h": 4,
                       "w": 5}) == (3 * 200, 3 * 7)
    sel = spec.load_module("roofline", "select4_kernel")
    assert sel.counts({"beams": 3, "itemsize": 1}) == (3 * 28, 24)
    assert sel.counts({"beams": 3, "itemsize": 4}) == (3 * 40, 24)
    edt = spec.load_module("roofline", "edt_tile")
    # 2 x 3 x 4 cells, radius 1: 3 offsets, 4 operations each
    assert edt.counts({"particles": 2, "h": 3, "w": 4,
                       "radius": 1}) == (24 * 5, 24 * 4 * 3)
    assert math.isclose(peaks.bound_us(3.35e6, 0.0), 1.0)
    assert math.isclose(peaks.bound_us(0.0, 67e6), 1.0)
    assert math.isclose(peaks.bound_us(3.35e6, 134e6), 2.0)


def test_every_route_closes():
    for f in sorted(os.listdir(os.path.join(BENCH, "traffic"))):
        traffic = spec.load_json(os.path.join(BENCH, "traffic", f))
        poses = traffic_mod.lap_poses(traffic["route"], 0.025)
        np.testing.assert_array_equal(poses[-1], poses[0])
        steps = np.linalg.norm(np.diff(poses[:, :2], axis=0), axis=1)
        # one scan's travel each (chords of the smoothed bends a bit less),
        # the seam between laps like any other step
        assert np.ptp(steps) < 1e-3 * steps.mean()
        assert abs(steps.mean() - 0.025) < 1e-4


def test_the_stream_integrates_the_lap_for_ever():
    traffic = spec.load_json(os.path.join(BENCH, "traffic",
                                          "office_loop.json"))
    sensor = {"beams": 31, "fov_deg": 270.0, "max_range_m": 10.0,
              "rate_hz": 2.0}
    lap = traffic_mod.make_lap(traffic, sensor, 2 ** 40 + 3, "cpu")
    again = traffic_mod.make_lap(traffic, sensor, 2 ** 40 + 3, "cpu")
    np.testing.assert_array_equal(lap.deltas, again.deltas)
    assert all(np.array_equal(a, b) for a, b in zip(lap.points,
                                                    again.points))
    st = traffic_mod.Stream(lap)
    seen = [st.next() for _ in range(2 * lap.n + 1)]
    assert seen[lap.n][0] == 0 and seen[2 * lap.n][2] == 2 * lap.n / 2.0
    # with the noise taken out, one lap of increments returns to the start
    true = traffic_mod.between(np.roll(lap.poses, 1, axis=0), lap.poses)
    odom = (0.0, 0.0, 0.0)
    for d in true[1:].tolist() + [true[0].tolist()]:
        odom = traffic_mod.compose(odom, d)
    assert np.allclose(odom, 0.0, atol=1e-9)


def test_scan_cells_counts_the_rays_cells():
    # one beam 0.5 m ahead (hit cell 10, 9 cells between) and one 0.26 m
    # up and 0.1 m across, seen from a pose turned by 90 degrees
    pts = np.array([[0.5, 0.0, 0.0], [0.26, -0.1, 0.0]])
    hits, free = traffic_mod.scan_cells([pts], [(0.0, 0.0, 0.0)], 0.05)
    assert (hits, free) == (2, 9 + 4)
    hits, free = traffic_mod.scan_cells([pts], [(0.0, 0.0, np.pi / 2)], 0.05)
    assert (hits, free) == (2, 9 + 4)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    bad = []
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(root, f)
                bad += [(p, m) for m in _imports(p)
                        if m and m.split(".")[0] in FORBIDDEN]
    assert not bad
    # the span targets name the port, compared by whole top-level name
    for d in os.listdir(os.path.join(BENCH, "drivers")):
        if d.endswith(".py"):
            mod = spec.load_module("drivers", d[:-3])
            for target in getattr(mod, "SPANS", {}).values():
                assert target.split(".")[0] == "iris_lama_tpu_torch"


def test_the_reference_imports_no_part_of_the_program():
    for f in os.listdir(os.path.join(BENCH, "reference")):
        if f.endswith(".py"):
            mods = list(_imports(os.path.join(BENCH, "reference", f)))
            assert not [m for m in mods if m.split(".")[0] in
                        FORBIDDEN | {"iris_lama_tpu_torch"}]


def test_readers_on_a_made_up_trace():
    ms = 1_000_000
    view = TraceView(
        window=(0, 100 * ms),
        spans={"update": [(10 * ms, 40 * ms), (50 * ms, 90 * ms)],
               "match": [(12 * ms, 30 * ms), (55 * ms, 60 * ms)],
               "map_update": [(30 * ms, 35 * ms)],
               "reorg": [(60 * ms, 80 * ms)]},
        device=[("void edt_tile(int)", 20 * ms, 21 * ms),
                ("void edt_tile(int)", 20 * ms + ms // 2, 22 * ms),
                ("Memset (Device)", 70 * ms, 71 * ms)],
        runtime=[("cudaStreamSynchronize", 15 * ms, 16 * ms),
                 ("cudaMemcpyAsync", 15 * ms, 15 * ms + 1),
                 ("cudaLaunchKernel", 19 * ms, 19 * ms + 1)],
        n_updates=2,
        kernel_calls={"edt_tile": {"particles": 1, "h": 67, "w": 100,
                                   "radius": 1}},
        busy=[tuple(b) for b in merged([(20 * ms, 21 * ms),
                                        (20 * ms + ms // 2, 22 * ms),
                                        (70 * ms, 71 * ms)])],
        host={"updates": 150, "seconds": 2.5})

    def read(name):
        return spec.load_module("metrics", name).read(view)

    assert read("match_ms") == pytest.approx(23 / 2)
    assert read("host_updates_per_s") == pytest.approx(60.0)
    assert read("map_update_ms") == pytest.approx(5 / 2)
    assert read("reorg_ms") == pytest.approx(20 / 2)
    # update spans 30 + 40 ms, less 18 + 5 + 5 + 20 ms of child spans
    assert read("driver_self_ms") == pytest.approx((70 - 48) / 2)
    assert read("host_syncs_per_update") == pytest.approx(0.5)
    assert read("device_ops_per_update") == pytest.approx(1.5)
    assert read("device_idle_pct") == pytest.approx(97.0)
    cells = 67 * 100
    want = 2 * peaks.bound_us(cells * 5, cells * 12) / 2500.0 * 100
    assert read("kernels_roofline") == pytest.approx(want)
    assert kernel_base("void select4_kernel<signed char>(signed char*)") \
        == "select4_kernel"
    assert kernel_base("void (anonymous namespace)::select4_kernel<signed "
                       "char>(signed char const*, int)") == "select4_kernel"
    assert kernel_base("void gn::gn_solve_kernel<signed char, 4, true, "
                       "false>(signed char const*)") == "gn_solve_kernel"
    assert kernel_base("Memset (Device)") == "Memset"
    assert view.host_label(25 * ms) == "match"
    assert view.host_label(45 * ms) == "harness"


def test_benchmark_json_keeps_to_the_contract():
    s = spec.load_spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert "setup_s" in {m["name"] for m in s["end_to_end"]}
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(s)) < 64 * 1024
