"""The port's summaries and small utility modules against the JAX package,
on the CPU.

* ``utils/summary.py``: Welford, TimerRegistry and ``Summary.report``
  equal to the JAX package's for the same probes;
* ``create_summary`` / ``detailed_summary`` on Slam2D and PFSlam2D
  (tests/test_slam2d_e2e.py:89, :255 and tests/test_pf_slam2d.py:260 on
  the port), each run's trajectory equal to the same run without them;
* ``utils/dataset.py``: the CARMEN writer and reader against the JAX
  package's reader;
* ``core/timing``, ``core/random``, ``utils/printing``,
  ``parallel/host_pool`` and ``utils/devprof``'s refusal without CUDA.
"""

import io
import time

import numpy as np
import pytest
import torch

from iris_lama_tpu.core import random as jrandom
from iris_lama_tpu.utils import dataset as jds
from iris_lama_tpu.utils import printing as jprinting
from iris_lama_tpu.utils import simulator as jsim
from iris_lama_tpu.utils import summary as jsummary

from iris_lama_tpu_torch.algos import pf_slam2d as tpf
from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
from iris_lama_tpu_torch.core import random as trandom
from iris_lama_tpu_torch.core import timing
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.parallel import host_pool
from iris_lama_tpu_torch.utils import dataset as tds
from iris_lama_tpu_torch.utils import devprof
from iris_lama_tpu_torch.utils import printing as tprinting
from iris_lama_tpu_torch.utils import summary as tsummary


# ---------------------------------------------------------------------------
# utils/summary.py
# ---------------------------------------------------------------------------

def _probes(rng):
    out = []
    for k in range(7):
        out.append(dict(timestamp=0.1 * k + rng.uniform(0, 0.01),
                        total=rng.uniform(0.001, 0.02),
                        solving=rng.uniform(0, 0.01) if k else 0.0,
                        mapping=rng.uniform(0, 0.01),
                        normalizing=rng.uniform(0, 1e-3) if k % 2 else 0.0,
                        resampling=0.0,
                        memory=float(rng.integers(1, 1 << 30))))
    return out


@pytest.mark.parametrize("n", [0, 1, 7])
def test_summary_report_matches_jax(n):
    probes = _probes(np.random.default_rng(n))[:n]
    a, b = tsummary.Summary(), jsummary.Summary()
    for p in probes:
        a.probe(**p)
        b.probe(**p)
    assert a.report() == b.report()
    assert a.time_total == b.time_total and a.memory == b.memory


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_welford_and_timers_match_jax():
    xs = np.random.default_rng(1).normal(3.0, 2.0, 100)
    a, b = tsummary.Welford(), jsummary.Welford()
    for x in xs:
        a.add(float(x))
        b.add(float(x))
    assert (a.n, a.mean, a.m2, a.var, a.std) == (b.n, b.mean, b.m2, b.var,
                                                 b.std)
    assert abs(a.std - xs.std(ddof=1)) < 1e-9
    reg = tsummary.TimerRegistry()
    with reg.scoped("phase"):
        time.sleep(0.01)
    assert reg.timers["phase"].mean >= 0.008
    jreg = jsummary.TimerRegistry()
    jreg.timers = reg.timers
    assert reg.report() == jreg.report() and "phase" in reg.report()


def test_phase_clock_marks_phases():
    clock = tsummary.PhaseClock("cpu")
    time.sleep(0.002)
    clock.mark("solving")
    clock.mark("mapping")
    assert list(clock.phases) == ["solving", "mapping"]
    assert clock.phases["solving"] >= 0.0015 and clock.phases["mapping"] >= 0


# ---------------------------------------------------------------------------
# the drivers' summaries
# ---------------------------------------------------------------------------

SLAM_OPTS = dict(resolution=0.1, patch_size=16, max_range=8.0,
                 trans_thresh=0.2, rot_thresh=0.2, capacity=1024)


def _slam_run(data, n, **kw):
    slam = Slam2D(Slam2DOptions(**SLAM_OPTS, **kw), device="cpu")
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    for k in range(n):
        slam.update(data.clouds[k], data.odometry[k], data.timestamps[k])
    return slam


@pytest.fixture(scope="module")
def slam_runs():
    data = jsim.simulate(jsim.SimConfig(
        n_steps=30, seed=2, laser=jsim.LaserSpec(n_beams=120,
                                                 max_range=8.0)))
    return {name: _slam_run(data, n, **kw) for name, n, kw in (
        ("plain", 30, {}), ("summary", 30, dict(create_summary=True)),
        ("detailed", 25, dict(create_summary=True, detailed_summary=True)))}


def test_summary_report_path(slam_runs):
    slam = slam_runs["summary"]
    rep = slam.summary.report()
    assert "updates:" in rep and "Hz" in rep and "MiB" in rep
    assert slam.memory_usage() > 0
    assert len(slam.summary.time_total) == len(slam.trajectory())
    # the summary changes nothing
    np.testing.assert_array_equal(slam.trajectory(),
                                  slam_runs["plain"].trajectory())
    assert slam_runs["plain"].summary is None


def test_detailed_summary_phase_split(slam_runs):
    slam = slam_runs["detailed"]
    s = slam.summary
    assert len(s.time_total) > 5
    # phases measured apart and both nonzero (not one copied time)
    assert sum(s.time_solving[1:]) > 0 and sum(s.time_mapping[1:]) > 0
    assert any(abs(a - b) > 1e-9 for a, b in
               zip(s.time_solving[1:], s.time_mapping[1:]))
    assert all(sv + mp <= tt for sv, mp, tt in
               zip(s.time_solving[1:], s.time_mapping[1:], s.time_total[1:]))
    assert "solving" in s.report() and "mapping" in s.report()
    traj = slam.trajectory()
    np.testing.assert_array_equal(
        traj, slam_runs["plain"].trajectory()[:len(traj)])


def test_pf_detailed_summary_phase_split():
    data = jsim.simulate(jsim.SimConfig(
        n_steps=30, seed=2, laser=jsim.LaserSpec(n_beams=120, max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))
    runs = []
    for kw in ({}, dict(create_summary=True, detailed_summary=True)):
        f = tpf.PFSlam2D(tpf.PFSlam2DOptions(
            particles=8, resolution=0.1, patch_size=16, max_range=8.0,
            capacity=1024, trans_thresh=0.3, rot_thresh=0.3, max_iter=30,
            seed=5, meas_sigma_gain=1.0, **kw), device="cpu")
        f.set_prior(Pose2D(*data.poses_gt[0]))
        for k in range(len(data.clouds)):
            f.update(data.clouds[k], data.odometry[k], data.timestamps[k])
        f._flush_motion()
        runs.append(f)
    plain, f = runs
    s = f.summary
    assert len(s.time_total) > 3
    for xs in (s.time_solving, s.time_normalizing, s.time_resampling,
               s.time_mapping):
        assert sum(xs[1:]) > 0
    rep = s.report()
    for row in ("solving", "normalizing", "resampling", "mapping"):
        assert row in rep
    assert f.memory_usage() > 0
    for name in ("pose", "weight", "res_dist", "res_occ"):
        assert torch.equal(getattr(f.pset, name), getattr(plain.pset, name))


# ---------------------------------------------------------------------------
# utils/dataset.py (CARMEN)
# ---------------------------------------------------------------------------

def test_carmen_roundtrip_matches_jax(tmp_path):
    recs = []
    for k in range(3):
        angles = np.linspace(-np.pi / 2, np.pi / 2, 181)
        r = np.full(181, 4.0 + k) + 0.01 * np.sin(np.arange(181))
        r[7] = 100.0                       # beyond max_range: dropped
        cloud = tds.PointCloudXYZ.from_ranges(r, angles, 80.0)
        recs.append(tds.LaserScanRecord(cloud, Pose2D(k, -k, 0.1 * k),
                                        float(k) + 0.25))
    path = str(tmp_path / "log.clf")
    tds.write_carmen_flaser(path, recs)
    jpath = str(tmp_path / "jlog.clf")
    jds.write_carmen_flaser(jpath, recs)
    assert open(path).read() == open(jpath).read()
    got, want = list(tds.read_carmen_log(path)), list(jds.read_carmen_log(
        path))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.cloud.points.tobytes() == w.cloud.points.tobytes()
        assert g.odometry.xyr().tolist() == list(w.odometry.xyr())
        assert g.timestamp == w.timestamp
        np.testing.assert_allclose(
            np.linalg.norm(g.cloud.points[:, :2], axis=1), 4.0 + g.timestamp
            - 0.25, atol=2e-2)
    n = 5
    line = (f"ROBOTLASER1 0 -1.5708 3.14159 0.785398 30.0 0.01 0 {n} "
            f"1.0 2.0 3.0 4.0 5.0 0 1.0 2.0 0.5 1.0 2.2 0.6 0 0 0 0 0 "
            f"123.456 host 123.5\nBOGUS 1 2\nFLASER x\n")
    g = list(tds.read_carmen_log(io.StringIO(line)))
    w = list(jds.read_carmen_log(io.StringIO(line)))
    assert len(g) == len(w) == 1
    assert g[0].cloud.points.tobytes() == w[0].cloud.points.tobytes()
    assert (g[0].cloud.sensor_origin.tobytes()
            == w[0].cloud.sensor_origin.tobytes())
    assert g[0].odometry.xyr().tolist() == list(w[0].odometry.xyr())
    assert g[0].timestamp == w[0].timestamp == 123.456


# ---------------------------------------------------------------------------
# timing, random, printing, host_pool, devprof
# ---------------------------------------------------------------------------

def test_timing():
    d = timing.Duration(1.5) + timing.Duration(ns=250)
    assert d.ns == 1_500_000_250 and abs(d.to_sec() - 1.50000025) < 1e-12
    assert timing.Duration(1.0) < timing.Duration(2.0)
    t0 = timing.Time(seconds=10.0)
    assert (t0 + timing.Duration(0.5)).to_sec() == 10.5
    assert (timing.Time(seconds=12.0) - t0).to_sec() == 2.0
    tm = timing.Timer()
    assert tm.elapsed().ns == 0
    tm.reset()
    time.sleep(0.002)
    assert tm.elapsed().to_sec() >= 0.0015
    t = time.perf_counter()
    rate = timing.Rate(500.0)
    rate.sleep()
    assert time.perf_counter() - t >= 0.0015
    ef = timing.EventFrequency(window=4)
    assert ef.frequency() == 0.0
    for _ in range(6):
        ef.event()
        time.sleep(0.001)
    assert len(ef._stamps) == 4 and ef.frequency() > 0


def test_random_matches_jax():
    for mod in (trandom, jrandom):
        assert mod.set_seed(42) == 42 and mod.seed() == 42
    draws = [(m.uniform(-1, 2), m.normal(0.5, 3.0), m.integers(0, 100))
             for m in (trandom, jrandom)]
    assert draws[0] == draws[1]
    s = trandom.set_seed(0)               # 0: a fresh seed from the clock
    assert s > 0 and trandom.seed() == s


def test_printing_matches_jax():
    assert tprinting.format("%d-%.2f %s", 3, 1.5, "x") == \
        jprinting.format("%d-%.2f %s", 3, 1.5, "x") == "3-1.50 x"
    assert tprinting.format("100%") == "100%"
    buf = io.StringIO()
    tprinting.print_("a%sb\n", 1, file=buf)
    assert buf.getvalue() == "a1b\n"


def test_host_pool():
    pool = host_pool.ThreadPool()
    pool.init(2)
    out = []
    for k in range(8):
        pool.enqueue(out.append, k)
    pool.wait()
    assert sorted(out) == list(range(8))
    pool.enqueue(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        pool.wait()
    pool.shutdown()
    with pytest.raises(AssertionError):
        pool.enqueue(out.append, 9)


def test_devprof_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (devprof.device_time_ms, devprof.device_breakdown):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(lambda: None, lambda k: ())
