"""GraphSlam2D's benchmark check (``benchmark/reference/graph_slam2d.py``,
loaded by path) against the port's ``GraphSlam2D(device="cpu")``.

One seeded route of the benchmark's traffic generator through a small
walled loop (12 x 8 m round a 6 x 2 m block, 28 m a lap, 0.1 m a scan),
a 256-beam lidar and 0.1 m cells, driven as the benchmark's mapping node
drives it (``benchmark/drivers/graph_slam2d.py``: every scan through
``update``, the pose read after each integrated update, the map published
every 200 updates) for two laps, so loops close twice round.
The plain reference gives the same key poses, candidate lists and
verification decisions, the same coarse fallback, the same factors and
correction, the same published map, and the LM's key poses within the
check's limits; the control (the reference in bfloat16) and each planted
fault fail the check. The metric readers run on a hand-made trace.
"""

import ast
import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path[:0] = [BENCH]

from harness import spec, traffic as traffic_mod  # noqa: E402
from harness.trace import TraceView  # noqa: E402
from harness.window import feed, warm_up  # noqa: E402

SEED = 2 ** 33 + 7
TRAFFIC = {
    "world": {"walls": [], "boxes": [{"corners": [0.0, 0.0, 12.0, 8.0]},
                                      {"corners": [3.0, 3.0, 9.0, 5.0]}]},
    "route": {"waypoints": [[1.5, 1.5], [10.5, 1.5], [10.5, 6.5],
                            [1.5, 6.5], [1.5, 1.5]], "smooth": 4},
    "speed_mps": 4.0,
    "odometry_noise": {"trans_per_m": 0.0556, "rot_per_m": 0.0111},
    "range_noise_m": 0.01,
    "warmup": {"updates": 5, "reorgs": 0},
}
SENSOR = {"beams": 256, "fov_deg": 270.0, "max_range_m": 6.0,
          "rate_hz": 40.0}
SCANS = 450            # two laps after the warm-up: an optimisation
CPU = torch.device("cpu")
# each fault: the number that reads it, and the window's scans it needs to
# show (the fourth key pose; the first candidates, accepted loops and coarse
# jobs; an optimisation that one LM step leaves short)
FAULTS = {"key_moved": ("keys_differ", 100),
          "candidate_skipped": ("candidates_differ", 300),
          "loop_dropped": ("decisions_differ", 300),
          "loop_inverted": ("factor_gap_m", 300),
          "coarse_shifted": ("coarse_rmse_gap", SCANS),
          "lm_one_step": ("pgo_gap_m", SCANS)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config() -> dict:
    c = copy.deepcopy(spec.load_json(spec.ROOT / "benchmark" / "configs"
                                     / "graph_slam2d.json"))
    c["sensor"] = dict(c["sensor"], **SENSOR)
    c["front_end"].update(resolution=0.1, patch_size=16, capacity=1024)
    c["check"].update(samples=3, sample_from=400, verify_samples=2,
                      verify_from=4, coarse_samples=2, coarse_from=2)
    return c


def _run(scans: int, fault=None) -> tuple:
    """Warm up, then ``scans`` scans of the window; returns (lap, record,
    the node's outputs, config)."""
    cfg = _config()
    driver = spec.load_module("drivers", "graph_slam2d")
    undo = driver.FAULTS[fault]() if fault else None
    try:
        lap = traffic_mod.make_lap(TRAFFIC, cfg["sensor"], SEED, CPU)
        clouds = [driver.Node.cloud(p) for p in lap.points]
        node = driver.Node(cfg, SEED, CPU, lap.poses[0])
        stream = traffic_mod.Stream(lap)
        record = []
        warm_up(node, clouds, stream, TRAFFIC["warmup"], record, 100)
        ordinal = 0
        for _ in range(scans):
            if feed(node, clouds, stream, record, True) is not None:
                node.observe(ordinal)
                ordinal += 1
        return lap, record, node.outputs(), cfg
    finally:
        if undo:
            undo()


def _reference():
    return spec.load_module("reference", "graph_slam2d")


def _events(out, name):
    return [r for r in out["journal"] if r["event"] == name]


@pytest.fixture(scope="module")
def route():
    lap, record, out, cfg = _run(SCANS)
    nums = _reference().numbers(lap, record, out, cfg, SEED, CPU)
    return lap, record, out, cfg, nums


def test_the_route_closes_loops_optimises_and_publishes(route):
    _, record, out, _, nums = route
    assert sum(f["loop"] for f in _events(out, "factor")) >= 10
    # one optimisation in the window, and the drain's after it
    assert sum(r["window"] is True for r in _events(out, "optimize")) >= 1
    assert len(_events(out, "optimize")) >= 2
    assert _events(out, "publish")[-1]["window"] is True
    assert len(record) > 2 * 200
    assert len(out["samples"]["verify"]) == 2
    assert len(out["samples"]["coarse"]) == 2
    assert nums["samples_missing"] == 0


def test_key_poses_and_candidates_equal_the_plain_search(route):
    lap, record, out, cfg, nums = route
    ref = _reference()
    raw = torch.tensor([u.raw for u in record], dtype=torch.float32)
    o = cfg["options"]
    assert ref.gate(raw, o["key_pose_distance"],
                    o["key_pose_angular_distance"]) == \
        ref.key_updates(out, record, lap.hz)
    assert nums["keys_differ"] == 0
    assert nums["candidates_differ"] == 0
    assert sum(len(d["rows"]) for d in _events(out, "dispatch")) > 50


def test_verification_decisions_equal_the_reference_order(route):
    _, _, out, _, nums = route
    assert nums["decisions_differ"] == 0
    assert nums["rmse_gap"] <= 1e-6
    # the coarse fallback ran, the acceptance order used it, and its
    # sampled jobs give the plain coarse registration's RMSE
    assert _events(out, "coarse")
    assert nums["coarse_rmse_gap"] <= 1e-6


def test_factors_and_correction_equal_the_replay(route):
    _, _, out, cfg, nums = route
    limits = cfg["check"]["limits"]
    # loop factors among them, some from sampled rows or jobs
    assert any(f["loop"] for f in _events(out, "factor"))
    for name in ("factor_gap_m", "factor_gap_rad", "correction_gap_m",
                 "correction_gap_rad"):
        assert nums[name] <= limits[name], (name, nums[name])


def test_optimised_key_poses_within_the_plain_float64_lm(route):
    _, _, _, cfg, nums = route
    limits = cfg["check"]["limits"]
    assert nums["pgo_gap_m"] <= limits["pgo_gap_m"]
    assert nums["pgo_gap_rad"] <= limits["pgo_gap_rad"]


def test_published_map_equals_the_plain_rebuild(route):
    *_, nums = route
    assert nums["map_counts_differ"] == 0
    assert nums["map_dist_differ"] == 0


def test_front_end_matches_equal_the_plain_match(route):
    *_, nums = route
    assert nums["pose_gap_m"] <= 1e-6
    assert nums["pose_gap_rad"] <= 1e-6


def test_the_control_fails_the_check(route):
    lap, record, out, cfg, _ = route
    got = _reference().numbers(lap, record, out, cfg, SEED, CPU,
                               dtype=torch.bfloat16)
    limits = cfg["check"]["limits"]
    assert [k for k, v in got.items() if v > limits[k]], got


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_fails_the_check(fault):
    name, scans = FAULTS[fault]
    lap, record, out, cfg = _run(scans, fault)
    nums = _reference().numbers(lap, record, out, cfg, SEED, CPU)
    assert nums[name] > cfg["check"]["limits"][name], nums


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_no_jax_and_no_port():
    bad = {"jax", "jaxlib", "flax", "iris_lama_tpu", "iris_lama_tpu_torch"}
    for name in ("graph_slam2d", "slam2d", "plain"):
        path = os.path.join(BENCH, "reference", name + ".py")
        mods = [m for m in _imports(path) if m]
        assert not [m for m in mods if m.split(".")[0] in bad], (name, mods)
    # what it takes from the benchmark: the plain helpers and the Slam2D
    # check's, checked above
    assert {m for m in _imports(os.path.join(BENCH, "reference",
                                             "graph_slam2d.py"))
            if m.startswith("reference")} == {"reference"}


def test_graph_metric_readers_on_a_made_up_trace():
    ms = 1_000_000
    view = TraceView(
        window=(0, 100 * ms),
        spans={"update": [(0, 40 * ms), (50 * ms, 90 * ms)],
               "close_loops": [(5 * ms, 15 * ms)],
               # a draining harvest nests in itself
               "harvest": [(20 * ms, 30 * ms), (25 * ms, 28 * ms),
                           (60 * ms, 62 * ms)],
               "find_candidates": [(6 * ms, 7 * ms), (8 * ms, 9 * ms),
                                   (10 * ms, 11 * ms)],
               "publish": [(55 * ms, 80 * ms)]},
        device=[], runtime=[], n_updates=4, kernel_calls={}, busy=[])

    def read(name):
        return spec.load_module("metrics", name).read(view)

    assert read("loop_closure_ms") == pytest.approx((10 + 10 + 2) / 4)
    assert read("loop_queries_per_update") == pytest.approx(3 / 4)
    assert read("optimize_ms") == 0.0
    assert read("publish_ms") == pytest.approx(25 / 4)
    view.spans["optimize"] = [(64 * ms, 70 * ms)]
    assert read("optimize_ms") == pytest.approx(6 / 4)
    empty = TraceView(window=(0, ms), spans={}, device=[], runtime=[],
                      n_updates=0, kernel_calls={}, busy=[])
    for name in ("loop_closure_ms", "loop_queries_per_update",
                 "optimize_ms", "publish_ms"):
        assert spec.load_module("metrics", name).read(empty) is None
