"""The port's spans and host-read counters (``utils/trace.py``) on the CPU.

With no profiler a span is one shared no-op context; under
``torch.profiler`` the drivers' spans nest inside each update's
``lama.update``, each host read is one ``lama.read.<site>`` span and one
count, the PF draws one ``lama.motion.draw`` a queued odometry packet, and
the resample and re-org spans come exactly when those run; GraphSlam2D's
phases are ``lama.graph.<phase>`` spans, its work is counted under
``graph.*`` and its reads under their own sites, the pose graph's LM under
``pgo_stop``. Poses and maps are bit-identical with the profiler on and
off.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from iris_lama_tpu_torch.algos import graph_slam2d as tgraph
from iris_lama_tpu_torch.algos import pf_slam2d as tpf
from iris_lama_tpu_torch.algos import slam2d as tslam
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.match import match_surface_2d as tmatch
from iris_lama_tpu_torch.utils import simulator as tsim
from iris_lama_tpu_torch.utils import summary as tsummary
from iris_lama_tpu_torch.utils import trace

SLAM = dict(resolution=0.1, patch_size=16, max_range=6.0, capacity=512,
            trans_thresh=0.1, rot_thresh=0.1, max_iter=30)
PF = dict(particles=4, resolution=0.1, patch_size=16, max_range=8.0,
          capacity=1024, trans_thresh=0.3, rot_thresh=0.3, max_iter=30,
          seed=3, meas_sigma_gain=1.0, resident_extra_patches=2,
          host_reorg_slack=0.5)
N_SCANS = 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return tsim.simulate(tsim.SimConfig(
        n_steps=N_SCANS, seed=2,
        laser=tsim.LaserSpec(n_beams=120, max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))


def _slam(**kw):
    slam = tslam.Slam2D(tslam.Slam2DOptions(**dict(SLAM, **kw)),
                        device="cpu")
    return slam


def _pf(draws=None, **kw):
    return tpf.PFSlam2D(tpf.PFSlam2DOptions(**dict(PF, **kw)), device="cpu",
                        draws=draws)


def _run(driver, data, n=N_SCANS):
    """Feed ``n`` scans as a node does (the pose read after each
    integrated update). Returns the published poses."""
    driver.set_prior(Pose2D(*data.poses_gt[0]))
    poses = []
    for k in range(n):
        if driver.update(data.clouds[k], data.odometry[k]):
            poses.append(driver.pose().xyr())
    return np.asarray(poses)


def _spans(prof) -> dict:
    """{name: sorted [(start ns, end ns)]} of the ``lama.*`` events."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("lama."):
            s = ev.start_ns()
            out.setdefault(ev.name(), []).append((s, s + ev.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer) -> bool:
    """Every interval of ``inner`` lies within one of ``outer``."""
    return all(any(os <= s and e <= oe for os, oe in outer)
               for s, e in inner)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_span_off_is_shared_noop(monkeypatch):
    """With no profiler a span builds no profiler event: an update runs
    with the event's constructor made to fail, and every span is the one
    shared context."""
    def refuse(*a, **kw):
        raise AssertionError("a profiler event was built with no profiler")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert trace.span("lama.x") is trace.span("lama.y") is trace._OFF
    data = tsim.simulate(tsim.SimConfig(
        n_steps=4, seed=2, laser=tsim.LaserSpec(n_beams=60, max_range=6.0)))
    assert len(_run(_slam(), data, 4)) >= 2


def test_host_read_counts_and_returns():
    """``host_read`` returns ``tolist()`` (or the numpy array), counts one
    read under its site, and ``counts()`` is a copy."""
    before = trace.counts()
    t = torch.tensor([1.5, 2.0])
    assert trace.host_read(t, "test_site") == [1.5, 2.0]
    arr = trace.host_read(t, "test_site", numpy=True)
    assert isinstance(arr, np.ndarray) and arr.dtype == np.float32
    got = trace.counts()
    assert got["reads.test_site"] - before.get("reads.test_site", 0) == 2
    got["reads.test_site"] = -1
    assert trace.counts()["reads.test_site"] != -1


def test_slam2d_spans_nest_in_update(data):
    """Under the profiler each Slam2D update is one ``lama.update`` that
    holds its ``lama.stage``, ``lama.match`` and ``lama.map_update``; the
    match and map update come once an update (the first scan maps only)."""
    slam = _slam()
    poses, spans = _traced(lambda: _run(slam, data))
    n = len(poses)
    assert n >= 10
    assert len(spans["lama.update"]) == N_SCANS
    assert len(spans["lama.stage"]) == N_SCANS
    assert len(spans["lama.match"]) == n - 1
    assert len(spans["lama.map_update"]) == n
    for name in ("lama.stage", "lama.match", "lama.map_update",
                 "lama.read.irls_stop"):
        assert _inside(spans[name], spans["lama.update"]), name
    assert _inside(spans["lama.read.irls_stop"], spans["lama.match"])
    # the node's pose read follows its update (the first scan leaves the
    # prior, which the host holds)
    assert len(spans["lama.read.pose"]) == n - 1
    assert not _inside(spans["lama.read.pose"], spans["lama.update"])


@pytest.mark.parametrize("driver", ["slam2d", "pf"])
def test_irls_stop_spans_equal_reads(data, driver):
    """One ``lama.read.irls_stop`` span a read of the IRLS stop flag: the
    spans equal the ``reads.irls_stop`` counter's rise (the PF's B6 runs
    without host reads on the CPU path's solve as well), and every read
    of the run has its span."""
    f = _slam() if driver == "slam2d" else _pf()
    before = trace.counts()
    _, spans = _traced(lambda: _run(f, data))
    after = trace.counts()
    for key, value in after.items():
        if not key.startswith("reads."):
            continue
        site = key[len("reads."):]
        rise = value - before.get(key, 0)
        assert len(spans.get("lama.read." + site, ())) == rise, site
    if driver == "slam2d":
        assert after["reads.irls_stop"] > before.get("reads.irls_stop", 0)


@pytest.mark.parametrize("strategy", ["gn", "lm"])
def test_slam2d_match_route_on_the_cpu(data, strategy):
    """On the CPU Slam2D matches through the generic IRLS: ``match_route``
    reads "generic", and the IRLS reads its stop flag on the host at least
    once a matched update (every integrated update after the first scan),
    which B4's whole solve never does. B4 would serve GN on its window,
    never LM."""
    slam = _slam(strategy=strategy)
    assert slam.match_route == "generic"
    assert tmatch.route_serves("solve", slam.sopts,
                               slam.cfg.sq_dtype) == (strategy == "gn")
    before = trace.counts()
    _run(slam, data, 12)
    after = trace.counts()
    assert slam._n_updates > 3
    assert (after["reads.irls_stop"] - before.get("reads.irls_stop", 0)
            >= slam._n_updates - 1)


def test_pf_draw_spans_equal_packets(data):
    """One ``lama.motion.draw`` a queued odometry packet, inside
    ``lama.motion``; the packets of the gated scans wait in the queue and
    are drawn at the next integrated update."""
    normals = []

    class Draws:
        def __init__(self):
            self.gen = torch.Generator().manual_seed(5)

        def __call__(self, kind, shape):
            if kind == "normal":
                normals.append(shape)
                return torch.randn(shape, generator=self.gen).numpy()
            return torch.rand(shape, generator=self.gen).numpy()

    pf = _pf(draws=Draws())
    poses, spans = _traced(lambda: _run(pf, data))
    assert len(poses) >= 5
    # every scan after the first queues a packet; the last pose read
    # flushed the queue
    assert len(normals) == N_SCANS - 1
    assert len(spans["lama.motion.draw"]) == len(normals)
    assert _inside(spans["lama.motion.draw"], spans["lama.motion"])
    assert len(spans["lama.motion"]) <= len(poses)


@pytest.mark.parametrize("scroll_kp,kind", [(0, "scroll"), (2, "full")])
def test_pf_resample_and_reorg_spans(data, scroll_kp, kind):
    """``lama.resample`` once an integrated update after the first, inside
    its ``lama.update``; ``lama.reorg.scroll`` / ``lama.reorg.full`` once a
    re-org of that kind, and not otherwise."""
    pf = _pf(scroll_kp=scroll_kp)
    poses, spans = _traced(lambda: _run(pf, data))
    n_scroll, n_full = pf.n_scrolls, pf.n_reorgs - pf.n_scrolls
    assert (n_scroll if kind == "scroll" else n_full) >= 1
    assert len(spans["lama.resample"]) == len(poses) - 1
    assert len(spans.get("lama.reorg.scroll", ())) == n_scroll
    assert len(spans.get("lama.reorg.full", ())) == n_full
    for name in ("lama.resample", "lama.match", "lama.map_update",
                 "lama.reorg." + kind):
        assert _inside(spans[name], spans["lama.update"]), name
    if kind == "scroll":
        assert _inside(spans["lama.read.reorg_origin"],
                       spans["lama.reorg.scroll"])


def test_phase_closes_span_with_clock(data):
    """With the detailed summary each update's phases close with its spans:
    one ``lama.match`` and ``lama.resample`` an update after the first
    (``lama.map_update`` on the first scan too), each update's four phases timed, and the memory probe
    read once an update; ``phase`` with no clock is the plain span."""
    pf = _pf(create_summary=True, detailed_summary=True)
    poses, spans = _traced(lambda: _run(pf, data, 12))
    sm, n = pf.summary, len(poses) - 1
    assert n >= 1
    for name in ("lama.match", "lama.resample"):
        assert len(spans[name]) == n, name
    assert len(spans["lama.map_update"]) == n + 1     # and the first scan
    for phase_ms in (sm.time_solving, sm.time_normalizing,
                     sm.time_resampling, sm.time_mapping):
        assert all(t > 0 for t in phase_ms[1:])
    assert len(spans["lama.read.memory"]) == len(sm.time_total) == n + 1
    clock = tsummary.PhaseClock("cpu")
    with trace.phase("lama.test", clock, "tested"):
        pass
    assert set(clock.phases) == {"tested"}
    assert trace.phase("lama.test") is trace._OFF


def _slam_outputs(slam, poses):
    m = slam.map
    return [poses, slam.trajectory(), m.table.keys.numpy(),
            m.occupied.numpy(), m.visited.numpy(), m.dist.numpy()]


def _pf_outputs(pf, poses):
    ps = pf.pset
    return [poses, ps.pose.numpy(), ps.weight.numpy(), ps.res_dist.numpy(),
            ps.res_occ.numpy(), ps.maps.table.keys.numpy(),
            ps.maps.dist.numpy()]


@pytest.mark.parametrize("driver", ["slam2d", "pf"])
def test_profiler_leaves_results_bit_identical(data, driver):
    """The same run with the profiler on and off: poses and maps equal bit
    for bit."""
    def one():
        f = _slam() if driver == "slam2d" else _pf(scroll_kp=0)
        poses = _run(f, data)
        return (_slam_outputs if driver == "slam2d" else _pf_outputs)(
            f, poses)

    off = one()
    on, spans = _traced(one)
    assert spans["lama.update"]
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


GRAPH_PHASES = ("front_end", "sync", "key_scan", "close_loops", "correlate",
                "process_pending", "optimize", "rebuild")


def test_graph_slam2d_spans_counters_and_read_sites():
    """A GraphSlam2D run that verifies loop candidates, optimises and
    publishes its map: each timed phase is a ``lama.graph.<phase>`` span
    as often as ``stats`` counts it, the work is counted under
    ``graph.*``, its host reads under ``key_gate``, ``verify``,
    ``pgo_nodes`` and ``rebuild`` (each with its span), and the LM's stop
    flag under ``pgo_stop``: the optimisation adds no ``irls_stop``
    read."""
    data = tsim.simulate(tsim.SimConfig(
        n_steps=90, seed=8, laser=tsim.LaserSpec(n_beams=120,
                                                  max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))
    g = tgraph.GraphSlam2D(tgraph.GraphSlam2DOptions(
        slam=tslam.Slam2DOptions(resolution=0.1, patch_size=16,
                                 max_range=8.0, trans_thresh=0.25,
                                 rot_thresh=0.25, capacity=4096,
                                 transient_map=True),
        ignore_n_chain_poses=4, key_pose_head_delay=1,
        loop_max_candidates=2), device="cpu")
    before = trace.counts()

    def run():
        _run(g, data, 90)
        g.generate_occupancy_map()

    _, spans = _traced(run)
    mid, stats = trace.counts(), dict(g.stats)
    g.optimize_pose_graph()
    after = trace.counts()

    def rise(key, a=before, b=mid):
        return b.get(key, 0) - a.get(key, 0)

    for phase in GRAPH_PHASES:
        assert (len(spans.get("lama.graph." + phase, ()))
                == stats.get(phase + "_n", 0)), phase
    assert _inside(spans["lama.graph.key_scan"], spans["lama.graph.sync"])
    assert rise("graph.keys") == len(g._key_poses) > 10
    assert rise("graph.queries") > 0
    assert rise("graph.rows_verified") > 0
    assert rise("graph.optimizes") == stats.get("optimize_n", 0)
    assert rise("graph.publishes") == 1
    assert rise("graph.loops_accepted") == len(g._links)
    # a coarse batch holds one to four jobs and is read once
    assert (rise("reads.coarse") <= rise("graph.coarse_jobs")
            <= 4 * rise("reads.coarse"))
    for site in ("key_gate", "verify", "pgo_nodes", "rebuild"):
        assert rise("reads." + site) == len(spans["lama.read." + site]) > 0, \
            site
    assert len(spans["lama.rebuild"]) == len(spans["lama.rebuild.pack"]) == 1
    assert rise("reads.pgo_stop", mid, after) > 0
    assert rise("reads.irls_stop", mid, after) == 0
    assert rise("reads.pgo_nodes", mid, after) == 1
