"""PFSlam2D's motion step on the CPU: the queued odometry packets, their
draws and ``PFSlam2D._flush_motion``.

A flush stages the whole queue in one host buffer and hands it to
``ops.motion.apply_queue``: on CPU tensors its plain version
(``draw_from_motion`` packet by packet), on the card one launch, which
``tests/test_torch_cuda.py`` holds to the eager chain there. Here the
flush and the op on the staged queue are held to sequential draws. The
draw stream is the one the benchmark's check replays: one ``("normal",
(N, 3))`` a packet in queue order, then one ``("uniform", ())`` an
accepted update.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from iris_lama_tpu_torch.algos import pf_slam2d as tpf
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.ops import motion
from iris_lama_tpu_torch.utils import simulator
from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

SEED = 5
# the PF config of tests/test_torch_cuda.py::test_pf_on_card_matches_cpu
# on a route of ~0.33 m steps, so that packets queue behind the gate
RUN_OPTS = dict(particles=8, resolution=0.1, patch_size=16, max_range=8.0,
                capacity=1024, trans_thresh=0.5, rot_thresh=0.5, max_iter=30,
                seed=3, meas_sigma_gain=1.0, resident_extra_patches=2,
                host_reorg_slack=0.5)
RUN_STEPS, RUN_SCANS = 240, 14


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Poses(NamedTuple):
    """The part of a particle set the motion step reads and replaces."""

    pose: torch.Tensor


def packets(k: int, seed: int = 0) -> np.ndarray:
    """float32 [k, 4] odometry increments (x, y, cos, sin): zero motion, a
    negative dx, turns to within an ulp of +-pi (the yaw wrap), a pure
    rotation, then small steps as a 40 Hz stream gives."""
    rng = np.random.default_rng(seed)
    xyr = [(0.0, 0.0, 0.0), (-0.03, 0.002, -0.01), (0.0, 0.0, np.pi),
           (0.01, 0.0, np.pi - 1e-7), (0.0, 0.01, -np.pi + 1e-7),
           (0.0, 0.0, 0.2)]
    while len(xyr) < k:
        xyr.append((rng.normal(0.025, 0.01), rng.normal(0.0, 0.003),
                    rng.normal(0.0, 0.02)))
    return np.stack([Pose2D(*p).se2_array() for p in xyr[:k]]).astype(
        np.float32)


def start_poses(n: int) -> torch.Tensor:
    rng = np.random.default_rng(1)
    th = rng.uniform(-np.pi, np.pi, n)
    xy = rng.uniform(-20.0, 20.0, (n, 2))
    return torch.as_tensor(np.stack([xy[:, 0], xy[:, 1], np.cos(th),
                                     np.sin(th)], 1), dtype=torch.float32)


def sequential(opts, queue, poses, gen):
    """K calls of ``draw_from_motion``, one generator draw each."""
    for od in queue:
        eps = torch.randn((opts.particles, 3), generator=gen)
        poses = tpf.draw_from_motion(opts, eps, torch.as_tensor(od), poses)
    return poses


@pytest.mark.parametrize("route", ["flush", "op"])
@pytest.mark.parametrize("n", [1, 30, 512])
@pytest.mark.parametrize("k", [1, 21, 64])
def test_flush_equals_sequential_draws(k, n, route):
    """A flush of K packets equals K sequential ``draw_from_motion`` calls
    on the same generator draws, bit for bit: the driver's flush, and
    ``ops.motion.apply_queue`` on CPU tensors with the staged queue (the
    packets and the draws in one buffer, in queue order)."""
    opts = tpf.PFSlam2DOptions(particles=n, seed=SEED)
    pf = tpf.PFSlam2D(opts, device="cpu")
    pf.pset = _Poses(start_poses(n))
    queue = list(packets(k))
    pf._odelta_queue = list(queue)
    if route == "flush":
        pf._flush_motion()
        got = pf.pset.pose
        assert pf._odelta_queue == []
    else:
        staged, eps = pf._stage_motion(queue)
        assert staged.shape == (k, 4) and eps.shape == (k, n, 3)
        got = motion.apply_queue(opts, eps, staged, start_poses(n))
    want = sequential(opts, queue, start_poses(n),
                      torch.Generator().manual_seed(SEED))
    assert got.dtype == torch.float32 and got.shape == (n, 4)
    assert torch.equal(got, want)


class Recorder:
    """A draw source from a generator of the filter's seed that logs each
    call's kind and shape, and the draws."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)
        self.calls, self.draws = [], []

    def __call__(self, kind, shape):
        self.calls.append((kind, tuple(shape)))
        if kind == "normal":
            out = torch.randn(shape, generator=self.gen)
        else:
            out = torch.rand(shape, generator=self.gen)
        self.draws.append(out)
        return out


class Flushes:
    """Wraps a filter's ``_flush_motion`` to log each flush: the queue and
    the poses before it, the normal draws it made, the poses and the queue
    after it."""

    def __init__(self, pf, rec: Recorder):
        self.log, self._pf, self._rec = [], pf, rec
        self._flush = pf._flush_motion
        pf._flush_motion = self

    def __call__(self):
        pf, n_draws = self._pf, len(self._rec.draws)
        queue, pose = list(pf._odelta_queue), pf.pset.pose.clone()
        self._flush()
        self.log.append({"queue": queue, "before": pose,
                         "draws": self._rec.draws[n_draws:],
                         "after": pf.pset.pose.clone(),
                         "left": list(pf._odelta_queue)})

    def since(self, k: int) -> list:
        return self.log[k:]


@pytest.fixture(scope="module")
def run():
    """A short PF run on the CPU (the card test's config) with a recording
    draw source: per scan, whether it was integrated, the packets it
    flushed, the draws it made, the queue and poses around the update, and
    the flushes of the update and of the ``pose()`` read after it."""
    data = simulator.simulate(simulator.SimConfig(
        n_steps=RUN_STEPS, seed=2,
        laser=simulator.LaserSpec(n_beams=120, max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))
    padded = [pad_scan(c, beam_bucket(120)) for c in data.clouds[:RUN_SCANS]]
    opts = tpf.PFSlam2DOptions(**RUN_OPTS)
    rec = Recorder(opts.seed)
    pf = tpf.PFSlam2D(opts, device="cpu", draws=rec)
    pf.set_prior(Pose2D(*data.poses_gt[0]))
    flushes = Flushes(pf, rec)
    scans = []
    for i, scan in enumerate(padded):
        queued = len(pf._odelta_queue) + (i > 0)
        n_calls, n_flushes = len(rec.calls), len(flushes.log)
        pose = None if pf.pset is None else pf.pset.pose.clone()
        ok = pf.update_prepadded(*(torch.as_tensor(a) for a in scan),
                                 data.odometry[i])
        s = {"ok": ok, "queued": queued, "draws": rec.calls[n_calls:],
             "update": flushes.since(n_flushes), "pose_before": pose,
             "queue_after": len(pf._odelta_queue),
             "pose_after": pf.pset.pose.clone()}
        n_flushes = len(flushes.log)
        if ok:
            pf.pose()
        s["pose"] = flushes.since(n_flushes)
        scans.append(s)
    plain = tpf.PFSlam2D(opts, device="cpu")
    plain.set_prior(Pose2D(*data.poses_gt[0]))
    for i, scan in enumerate(padded):
        plain.update_prepadded(*(torch.as_tensor(a) for a in scan),
                               data.odometry[i])
    return {"scans": scans, "pose": pf.pset.pose, "lineage": pf.pset.lineage,
            "default_pose": plain.pset.pose,
            "default_lineage": plain.pset.lineage, "opts": opts}


def test_draws_follow_the_queue(run):
    """An injected draw source is called once a packet with ("normal",
    (N, 3)), in queue order, then once with ("uniform", ()) for the
    update; a gated scan draws nothing. The filter's own generator gives
    the same stream: a run on it lands on the same particles."""
    scans = run["scans"]
    integrated = [s for s in scans[1:] if s["ok"]]
    assert len(integrated) >= 3
    assert any(s["queued"] > 1 for s in integrated)
    n = RUN_OPTS["particles"]
    for s in scans[1:]:
        want = ([("normal", (n, 3))] * s["queued"] + [("uniform", ())]
                if s["ok"] else [])
        assert s["draws"] == want
    assert scans[0]["draws"] == []
    assert torch.equal(run["pose"], run["default_pose"])
    assert torch.equal(run["lineage"], run["default_lineage"])


def test_motion_counters(run):
    """An integrated update flushes once: its K queued packets leave the
    queue and move the poses as K sequential ``draw_from_motion`` calls on
    its K draws. A gated scan flushes nothing: the queue grows by its
    packet and the poses stay. The empty flush of ``pose()`` after an
    update leaves the poses bit-equal."""
    opts, scans = run["opts"], run["scans"]
    assert scans[0]["update"] == [] and scans[0]["queue_after"] == 0
    for s in scans[1:]:
        if s["ok"]:
            (f,) = s["update"]
            assert len(f["queue"]) == len(f["draws"]) == s["queued"]
            assert f["left"] == [] and s["queue_after"] == 0
            assert torch.equal(f["before"], s["pose_before"])
            want = f["before"]
            for eps, od in zip(f["draws"], f["queue"]):
                want = tpf.draw_from_motion(opts, eps, torch.as_tensor(od),
                                            want)
            assert torch.equal(f["after"], want)
            (p,) = s["pose"]
            assert p["queue"] == [] and p["draws"] == []
            assert torch.equal(p["after"], p["before"])
        else:
            assert s["update"] == [] and s["pose"] == []
            assert s["queue_after"] == s["queued"]
            assert torch.equal(s["pose_after"], s["pose_before"])
