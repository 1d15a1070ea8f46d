"""The port's GraphSlam2D against the JAX package, on the CPU.

Free runs of both packages, scan for scan, on the configurations of
tests/test_graph_slam2d.py's test_graph_slam_optimize_preserves_consistency
(120 steps, seed 9) and test_key_pose_gate_uses_slam_pose_not_odometry
(slipped odometry, ``sync_updates=4``): the same key-pose update indices
and the same ``links`` over the whole run, key poses within ``POSE_ATOL``
(1e-4 m / 1e-4 rad) up to the front end's first flip.

A flip: from one identical state, the front end's scan match lands in one
of two poses 7e-4 m apart, and which one turns on an ulp — moving the
start pose by 1e-7 switches the port between its own result and JAX's
(summation order in the normal equations; ROADMAP "Known and analysed").
Each run's first flip is found in the lockstep run and teacher-forced: the
port, loaded with JAX's state just before it, must land on JAX's pose
(within POSE_ATOL) for some start pose within 2e-7 of JAX's. Past the flip the key poses part by up to ~2 cm, so the
optimization, the map rebuild and the coarse distance map are checked on
JAX's end state carried across (``utils.state.graph_from_numpy``): poses
after ``optimize_pose_graph`` within POSE_ATOL, the rebuilt pool and the
coarse distance map bit-equal. ``key_scan`` (fired indices and rows,
bit-equal, a clamped start included) and the verification programs
``correlate`` and ``coarse`` (states and errors within 1e-5) are held
against JAX's on the same inputs. The assertions of
tests/test_graph_slam2d.py then run on the port alone.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos import graph_slam2d as jgraph
from iris_lama_tpu.algos.slam2d import Slam2DOptions as JSlamOptions
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.utils import simulator

import torch_parallel_ranks as ranks
from iris_lama_tpu_torch.algos import graph_slam2d as tgraph
from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.parallel import group as G
from iris_lama_tpu_torch.sdm import distance as tdist
from iris_lama_tpu_torch.utils import state as tstate
from iris_lama_tpu_torch.utils.cloud import PointCloudXYZ
from iris_lama_tpu_torch.utils.evaluation import ate_rmse

POSE_ATOL = 1e-4
VERIFY_ATOL = 1e-5
# start-pose moves of the teacher-forced flip: 0 and one or two 1e-7 steps
ULP_STEPS = (0.0, 1e-7, -1e-7, 2e-7, -2e-7)
TABLE = ("keys", "slots", "free_slots", "n_free", "overflow")

CONFIGS = {
    # test_graph_slam_optimize_preserves_consistency
    "optimize": dict(
        sim=dict(n_steps=120, seed=9),
        slam=dict(resolution=0.1, patch_size=16, max_range=8.0,
                  trans_thresh=0.25, rot_thresh=0.25, capacity=4096),
        graph={}, slip=False),
    # test_key_pose_gate_uses_slam_pose_not_odometry
    "gate": dict(
        sim=dict(n_steps=160, seed=11, odom_trans_noise=0.0,
                 odom_rot_noise=0.0),
        slam=dict(resolution=0.1, patch_size=16, max_range=8.0,
                  trans_thresh=0.1, rot_thresh=0.15, capacity=4096,
                  transient_map=True),
        graph=dict(sync_updates=4), slip=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(c):
    data = simulator.simulate(simulator.SimConfig(
        laser=simulator.LaserSpec(n_beams=120, max_range=8.0), **c["sim"]))
    odo = list(data.odometry)
    if c["slip"]:
        # odometry translation scaled 0.5 around the start pose
        x0, y0 = odo[0].x(), odo[0].y()
        odo = [JPose2D(x0 + 0.5 * (o.x() - x0), y0 + 0.5 * (o.y() - y0),
                       o.rotation()) for o in odo]
    return data, odo


def _port_graph(c, device="cpu"):
    return tgraph.GraphSlam2D(tgraph.GraphSlam2DOptions(
        slam=Slam2DOptions(**c["slam"]), **c["graph"]), device=device)


def _xyr(poses):
    return np.asarray([p.xyr() for p in poses])


def _pose_diff(a, b):
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    dth = np.abs(np.angle(np.exp(1j * (a[:, 2] - b[:, 2]))))
    return np.maximum(np.abs(a[:, :2] - b[:, :2]).max(1), dth)


def _lockstep(c):
    """Both packages scan for scan; the JAX front end's state is kept from
    just before each scan, so the first update whose poses part by more
    than POSE_ATOL is recorded with the state it started from."""
    data, odo = _data(c)
    jg = jgraph.GraphSlam2D(jgraph.GraphSlam2DOptions(
        slam=JSlamOptions(**c["slam"]), **c["graph"]))
    tg = _port_graph(c)
    jg.set_prior(JPose2D(*data.poses_gt[0]))
    tg.set_prior(Pose2D(*data.poses_gt[0]))
    flip = None
    for k in range(c["sim"]["n_steps"]):
        before = (tstate.slam_to_numpy(jg.slam)
                  if flip is None and jg.slam.has_first_scan else None)
        a = jg.update(data.clouds[k], odo[k], data.timestamps[k])
        b = tg.update(data.clouds[k], Pose2D(*odo[k].xyr()),
                      data.timestamps[k])
        assert a == b, f"scan {k}: accepted {a} (JAX) vs {b} (port)"
        if a and flip is None and before is not None:
            jp = np.asarray(jg.slam._pose_dev)
            tp = tg.slam._pose_dev.numpy()
            if _pose_diff(Pose2D.from_se2_array(jp).xyr(),
                          Pose2D.from_se2_array(tp).xyr())[0] > POSE_ATOL:
                flip = dict(scan=k, update=jg.slam._n_updates - 1,
                            state=before, jax_pose=jp, port_pose=tp)
    jkp, tkp = jg.key_poses, tg.key_poses      # drain both
    end = tstate.graph_to_numpy(jg)
    return dict(data=data, odo=odo, jg=jg, tg=tg, flip=flip, end=end,
                jkeys=_xyr(kp.pose for kp in jkp),
                tkeys=_xyr(kp.pose for kp in tkp),
                jts=[kp.timestamp for kp in jkp],
                tts=[kp.timestamp for kp in tkp])


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request):
    c = CONFIGS[request.param]
    return dict(name=request.param, c=c, **_lockstep(c))


def _carried(run):
    """A port GraphSlam2D holding JAX's end state."""
    tg = _port_graph(run["c"])
    tg.update(run["data"].clouds[0], Pose2D(*run["odo"][0].xyr()), 0.0)
    tstate.graph_from_numpy(tg, run["end"])
    return tg


def test_free_run_matches_jax(run):
    assert run["tts"] == run["jts"], "key-pose update indices differ"
    assert list(run["tg"].links) == list(run["jg"].links)
    d = _pose_diff(run["tkeys"], run["jkeys"])
    flip = run["flip"]
    if flip is None:
        assert d.max() <= POSE_ATOL, d.max()
        return
    # the key poses created before the front end's first flip agree
    t_flip = run["data"].timestamps[flip["scan"]]
    pre = [i for i, t in enumerate(run["jts"]) if t < t_flip]
    assert len(pre) > 10, (flip["scan"], run["jts"])
    assert d[pre].max() <= POSE_ATOL, d[pre]


def test_flip_is_an_ulp_flip(run):
    """Teacher-forced at the first flip: from JAX's state just before it,
    the port lands on JAX's pose for a start pose within 2e-7 of JAX's.
    (On the optimize configuration the unmoved start lands on the port's
    own free-run pose and a 1e-7 move on JAX's; on the gate configuration
    every start lands on JAX's, so there the parting came from the ulps by
    which the two free runs' states differ before the flip.)"""
    flip = run["flip"]
    if flip is None:
        pytest.skip("no flip on this run")
    data, odo = run["data"], run["odo"]
    k = flip["scan"]
    got = []
    for eps in ULP_STEPS:
        s = Slam2D(Slam2DOptions(**{**run["c"]["slam"],
                                    "transient_map": True}), device="cpu")
        s.update(data.clouds[0], Pose2D(*odo[0].xyr()), 0.0)
        d = dict(flip["state"])
        d["pose"] = d["pose"] + np.float32(eps)
        tstate.slam_from_numpy(s, d)
        assert s.update(data.clouds[k], Pose2D(*odo[k].xyr()),
                        data.timestamps[k])
        got.append(Pose2D.from_se2_array(s._pose_dev.numpy()).xyr())
    want = Pose2D.from_se2_array(flip["jax_pose"]).xyr()
    assert min(_pose_diff(g, want)[0] for g in got) <= POSE_ATOL, (got, want)


def test_optimize_teacher_forced(run):
    jg, tg = run["jg"], _carried(run)
    assert len(tg._key_poses) == len(jg._key_poses)
    jg.optimize_pose_graph()
    tg.optimize_pose_graph()
    d = _pose_diff(_xyr(kp.pose for kp in tg._key_poses),
                   _xyr(kp.pose for kp in jg._key_poses))
    assert d.max() <= POSE_ATOL, d.max()
    np.testing.assert_allclose(tg.correction.xyr(), jg.correction.xyr(),
                               atol=POSE_ATOL)


def test_generate_maps_teacher_forced(run):
    """generate_occupancy_map's pool and generate_coarse_distance_map(0.25,
    2.5) bit-equal on JAX's key poses carried across (on the optimize
    configuration: JAX's map calls cost ~17 s a configuration)."""
    if run["name"] != "optimize":
        pytest.skip("checked on the optimize configuration")
    jg, tg = run["jg"], _carried(run)
    for k, p in enumerate(jg._key_poses):      # any optimize above included
        tg._key_poses[k] = tg._key_poses[k]._replace(
            pose=Pose2D(*p.pose.xyr()))
    got = tstate.map_to_numpy(tg.generate_occupancy_map())
    want = jg.generate_occupancy_map()
    for f in TABLE:
        np.testing.assert_array_equal(got[f"table_{f}"],
                                      np.asarray(getattr(want.table, f)))
    for f in ("occupied", "visited", "dist"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))
    (ts, tcfg), (js, jcfg) = (g.generate_coarse_distance_map(0.25, 2.5)
                              for g in (tg, jg))
    assert tcfg.max_sqdist == jcfg.max_sqdist
    for f in TABLE:
        np.testing.assert_array_equal(getattr(ts.table, f).numpy(),
                                      np.asarray(getattr(js.table, f)))
    np.testing.assert_array_equal(ts.obstacle.numpy(), np.asarray(js.obstacle))
    np.testing.assert_array_equal(ts.dist.numpy(), np.asarray(js.dist))


def _rows(tg, n_queries=4):
    """Verification rows (qid, cid, ref_raw, cand_raw) for the last key
    poses with candidates within 10 m, as _dispatch_verification builds
    them."""
    inv = tg.correction.inverse()
    rows = []
    for qid in range(len(tg._key_poses) - 1, -1, -1):
        cands = tg._find_candidates(tg._key_poses[qid].pose.xy(), 10.0, qid)
        for cid in cands:
            rows.append((qid, cid, inv + tg._key_poses[qid].pose,
                         inv + tg._key_poses[cid].pose))
        if len({r[0] for r in rows}) >= n_queries:
            break
    return rows[:8]


def test_correlate_and_coarse_teacher_forced(run):
    """One verification batch and one coarse batch from one map (JAX's,
    carried across) and the same rows: states and errors within 1e-5."""
    jg, tg = run["jg"], _carried(run)
    rows = _rows(tg)
    assert rows
    jc, _, jcoarse = jgraph._make_graph_kernels(
        jg.slam.cfg, jg.options.key_pose_distance,
        jg.options.key_pose_angular_distance)
    tc, _, tcoarse = tgraph._make_graph_kernels(
        tg.slam.cfg, tg.options.key_pose_distance,
        tg.options.key_pose_angular_distance)
    k = next(b for b in (8, 16, 32) if len(rows) <= b)
    padded = (rows + [rows[0]] * k)[:k]
    cand = np.stack([r[3].se2_array() for r in padded])
    hyp = np.stack([JPose2D(r[2].x(), r[2].y(), r[3].rotation()).se2_array()
                    for r in padded])
    jkp, tkp = jg._key_poses, tg._key_poses
    want = np.asarray(jc(jg.slam.map, jnp.asarray(cand), jnp.asarray(hyp),
                         jnp.asarray(np.stack([jkp[r[1]].points[:, :2]
                                               for r in padded])),
                         jnp.asarray(np.stack([jkp[r[1]].mask
                                               for r in padded]))))
    n = len(rows)
    got = tc(tg.slam.map, torch.as_tensor(cand[:n]),
             torch.as_tensor(hyp[:n]),
             torch.stack([tkp[r[1]].points[:, :2] for r in rows]),
             torch.stack([tkp[r[1]].mask for r in rows])).numpy()
    np.testing.assert_allclose(got, want[:n], atol=VERIFY_ATOL)

    jobs = rows[:tgraph.COARSE_CHUNK]
    padded = (jobs + [jobs[0]] * 4)[:4]
    ref = np.stack([r[2].se2_array() for r in padded])
    cand = np.stack([r[3].se2_array() for r in padded])

    def clouds(kps, which, rows_):
        return [kps[r[which]] for r in rows_]

    want = np.asarray(jcoarse(
        jg.slam.map, jnp.asarray(ref),
        jnp.asarray(np.stack([kp.points[:, :2]
                              for kp in clouds(jkp, 0, padded)])),
        jnp.asarray(np.stack([kp.mask for kp in clouds(jkp, 0, padded)])),
        jnp.asarray(cand),
        jnp.asarray(np.stack([kp.points[:, :2]
                              for kp in clouds(jkp, 1, padded)])),
        jnp.asarray(np.stack([kp.mask for kp in clouds(jkp, 1, padded)]))))
    n = len(jobs)
    got = tcoarse(
        tg.slam.map, torch.as_tensor(ref),
        torch.stack([kp.points[:, :2] for kp in clouds(tkp, 0, padded)]),
        torch.stack([kp.mask for kp in clouds(tkp, 0, padded)]),
        torch.as_tensor(cand[:n]),
        torch.stack([kp.points[:, :2] for kp in clouds(tkp, 1, jobs)]),
        torch.stack([kp.mask for kp in clouds(tkp, 1, jobs)])).numpy()
    np.testing.assert_allclose(got, want[:n], atol=VERIFY_ATOL)


def test_state_round_trip(run):
    """graph_to_numpy of the carried port equals JAX's end state (float64
    poses to 1e-12: a pose's angle is wrapped on the way in)."""
    got = tstate.graph_to_numpy(_carried(run))
    want = run["end"]
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        if v.dtype == np.float64:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("k0", [0, 37, Slam2D.TRAJ_CAP - 64,
                                Slam2D.TRAJ_CAP - 20])
def test_key_scan_matches_jax(k0):
    """The gate replay on seeded trajectory blocks (a random walk whose
    steps fire now and then), a start past TRAJ_CAP - 64 included (JAX's
    dynamic_slice clamps it): the same fired indices and rows, bit for
    bit, and the same register."""
    rng = np.random.default_rng(k0 + 5)
    cap = Slam2D.TRAJ_CAP
    traj = np.zeros((cap, 4), np.float32)
    xy = np.cumsum(rng.normal(0, 0.3, (cap, 2)), 0)
    th = np.cumsum(rng.normal(0, 0.2, cap))
    traj[:, :2], traj[:, 2], traj[:, 3] = xy, np.cos(th), np.sin(th)
    last = traj[max(k0 - 1, 0)].copy()
    _, jscan, _ = jgraph._make_graph_kernels(
        JSlamOptions(transient_map=True).mapping_config(), 1.0, 0.5 * np.pi)
    for n in (64, 17):
        want, wlast = jscan(jnp.asarray(traj), jnp.int32(k0), jnp.int32(n),
                            jnp.asarray(last))
        got, glast = tgraph.key_scan(torch.as_tensor(traj), k0, n,
                                     torch.as_tensor(last), 1.0,
                                     0.5 * np.pi)
        want = np.asarray(want)
        assert int(want[-1, 0]) > 0
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(glast.numpy(), np.asarray(wlast))


# -- the assertions of tests/test_graph_slam2d.py, on the port alone ---------

def test_port_optimize_preserves_consistency(run):
    if run["name"] != "optimize":
        pytest.skip("the optimize configuration's assertions")
    tg = _port_graph(run["c"])
    data = run["data"]
    tg.set_prior(Pose2D(*data.poses_gt[0]))
    for k in range(run["c"]["sim"]["n_steps"]):
        tg.update(data.clouds[k], Pose2D(*run["odo"][k].xyr()),
                  data.timestamps[k])
    assert len(tg.key_poses) >= 5
    before = _xyr(kp.pose for kp in tg.key_poses)
    tg.optimize_pose_graph()
    after = _xyr(kp.pose for kp in tg.key_poses)
    assert np.linalg.norm(before[:, :2] - after[:, :2], axis=1).max() < 0.2
    assert int(tg.generate_occupancy_map().table.num_patches()) > 10


def test_port_key_pose_gate_uses_slam_pose(run):
    if run["name"] != "gate":
        pytest.skip("the gate configuration's assertions")
    kps = run["tg"].key_poses
    data = run["data"]
    assert len(kps) >= 4, len(kps)
    gaps = [np.linalg.norm((kps[i - 1].raw_pose - kps[i].raw_pose).xy())
            for i in range(1, len(kps))]
    assert 0.9 <= float(np.median(gaps)) <= 1.6, gaps
    assert max(gaps) < 1.9, gaps
    start = np.asarray(data.poses_gt[0][:2])
    true_dist = np.linalg.norm(
        np.asarray([p[:2] for p in data.poses_gt]) - start, axis=1).max()
    kp_dist = max(np.linalg.norm(kp.raw_pose.xy() - start) for kp in kps)
    assert kp_dist > 0.6 * true_dist, (kp_dist, true_dist)


def test_port_graph_slam_loop():
    cfg = simulator.SimConfig(
        n_steps=300, seed=8,
        laser=simulator.LaserSpec(n_beams=120, max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004)
    data = simulator.simulate(cfg)
    gs = tgraph.GraphSlam2D(tgraph.GraphSlam2DOptions(
        slam=Slam2DOptions(resolution=0.1, patch_size=16, max_range=8.0,
                           trans_thresh=0.25, rot_thresh=0.25, capacity=4096,
                           transient_map=True),
        ignore_n_chain_poses=10, key_pose_head_delay=3,
        loop_closure_scan_rmse=0.12), device="cpu")
    gs.set_prior(Pose2D(*data.poses_gt[0]))
    est, gt = [], []
    for k in range(cfg.n_steps):
        if gs.update(data.clouds[k], Pose2D(*data.odometry[k].xyr()),
                     data.timestamps[k]):
            est.append(gs.pose().xyr())
            gt.append(data.poses_gt[k])
    assert len(gs.key_poses) > 20, len(gs.key_poses)
    ate = ate_rmse(np.asarray(est), np.asarray(gt))
    assert ate < 0.1, (ate, len(gs.links))
    assert len(gs.links) >= 1, "no loop closures accepted"
    kp_xy = np.array([kp.pose.xy() for kp in gs.key_poses])
    assert np.ptp(kp_xy[:, 0]) > 15


def test_observer_records_the_machinery_and_changes_nothing():
    """``GraphSlam2D.observer`` is handed every key pose, factor,
    dispatched and harvested batch and optimisation, in the program's own
    values, and a run with an observer gives the poses of one without."""
    cfg = simulator.SimConfig(
        n_steps=300, seed=8,
        laser=simulator.LaserSpec(n_beams=120, max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004)
    data = simulator.simulate(cfg)

    def run(observer):
        gs = tgraph.GraphSlam2D(tgraph.GraphSlam2DOptions(
            slam=Slam2DOptions(resolution=0.1, patch_size=16, max_range=8.0,
                               trans_thresh=0.25, rot_thresh=0.25,
                               capacity=4096, transient_map=True),
            ignore_n_chain_poses=10, key_pose_head_delay=3,
            loop_closure_scan_rmse=0.12), device="cpu")
        gs.observer = observer
        gs.set_prior(Pose2D(*data.poses_gt[0]))
        poses = [gs.pose().xyr() for k in range(cfg.n_steps)
                 if gs.update(data.clouds[k], Pose2D(*data.odometry[k].xyr()),
                              data.timestamps[k])]
        gs.optimize_pose_graph()
        return gs, np.asarray(poses)

    events = []
    gs, poses = run(lambda e, f: events.append((e, f)))
    _, plain_poses = run(None)
    np.testing.assert_array_equal(poses, plain_poses)

    def of(name):
        return [f for e, f in events if e == name]

    kps = gs.key_poses
    assert [(k["id"], k["timestamp"]) for k in of("key")] == \
        [(kp.id, kp.timestamp) for kp in kps]
    np.testing.assert_array_equal([k["raw"].xyr() for k in of("key")],
                                  [kp.raw_pose.xyr() for kp in kps])
    facs = of("factor")
    b = gs._builder
    assert [(f["i"], f["j"]) for f in facs if f["i"] == f["j"]] == \
        [(p[0], p[0]) for p in b.priors]
    assert [(f["i"], f["j"], f["loop"]) for f in facs if f["i"] != f["j"]] \
        == [(e[0], e[1], e[4] > 0) for e in b.betweens]
    np.testing.assert_array_equal(
        [f["measurement"] for f in facs if f["i"] != f["j"]],
        [e[2] for e in b.betweens])
    assert [(f["i"], f["j"]) for f in facs if f["loop"]] == gs.links
    assert len(gs.links) >= 1
    # every dispatched row and coarse job is harvested once, in its kind
    for kind, name, key in (("verify", "dispatch", "rows"),
                            ("coarse", "coarse", "jobs")):
        sent = [r[:2] for d in of(name) for r in d[key]]
        got = [p for h in of("harvest") if h["kind"] == kind
               for p in h["pairs"]]
        assert sorted(sent) == sorted(got) and sent, kind
    assert all(h["packed"].shape == (len(h["pairs"]), 5)
               for h in of("harvest"))
    opt = of("optimize")
    assert len(opt) >= 2 and opt[-1]["out"] is not None
    np.testing.assert_array_equal(
        [Pose2D.from_se2_array(o).xyr() for o in opt[-1]["out"]],
        [kp.pose.xyr() for kp in kps])


def test_port_generate_coarse_distance_map():
    cfg = simulator.SimConfig(
        n_steps=80, seed=10,
        laser=simulator.LaserSpec(n_beams=100, max_range=8.0))
    data = simulator.simulate(cfg)
    gs = tgraph.GraphSlam2D(tgraph.GraphSlam2DOptions(
        slam=Slam2DOptions(resolution=0.1, patch_size=16, max_range=8.0,
                           trans_thresh=0.3, rot_thresh=0.3, capacity=2048)),
        device="cpu")
    gs.set_prior(Pose2D(*data.poses_gt[0]))
    for k in range(cfg.n_steps):
        gs.update(data.clouds[k], Pose2D(*data.odometry[k].xyr()),
                  data.timestamps[k])
    state, dcfg = gs.generate_coarse_distance_map(resolution=0.25,
                                                  l2_max=2.5)
    assert int(state.table.num_patches()) > 0
    kp = gs.key_poses[len(gs.key_poses) // 2]
    d, _ = tdist.interp_pool(state.table, state.dist, dcfg.geometry,
                             torch.as_tensor([kp.pose.xy()],
                                             dtype=torch.float32),
                             dcfg.max_dist)
    assert 0.05 < float(d[0]) <= dcfg.max_dist + 1e-6


def test_live_chunk_same_key_poses(run):
    """update_prepadded with live_chunk = 3 (accepted scans buffered and
    run three at a time): the same accepted scans and key poses as the
    per-scan path (the front end and the gate are the same)."""
    if run["name"] != "optimize":
        pytest.skip("checked on the optimize configuration")
    data, odo = run["data"], run["odo"]
    gs = tgraph.GraphSlam2D(tgraph.GraphSlam2DOptions(
        slam=Slam2DOptions(**run["c"]["slam"]), live_chunk=3), device="cpu")
    gs.set_prior(Pose2D(*data.poses_gt[0]))
    for k in range(run["c"]["sim"]["n_steps"]):
        gs.update(data.clouds[k], Pose2D(*odo[k].xyr()), data.timestamps[k])
    kps = gs.key_poses
    assert [kp.timestamp for kp in kps] == run["tts"]
    np.testing.assert_array_equal(_xyr(kp.pose for kp in kps), run["tkeys"])


def test_sharded_rebuild_equals_unsharded(run):
    """generate_occupancy_map(mesh=...) at world 2 on gloo (the driver's
    state carried to each rank) gives the unsharded rebuild's pool bit for
    bit, on every rank."""
    tg = _carried(run)
    want = tstate.map_to_numpy(tg.generate_occupancy_map())
    cloud = PointCloudXYZ(points=np.asarray(run["data"].clouds[0].points))
    got = G.run_ranks(ranks.graph_rebuild, 2, timeout=300, args=(
        tg.options, cloud, Pose2D(*run["odo"][0].xyr()),
        tstate.graph_to_numpy(tg)))
    for r, m in enumerate(got):
        assert set(m) == set(want)
        for k, a in want.items():
            np.testing.assert_array_equal(m[k], a, err_msg=f"rank {r} {k}")


def test_options_plain_defaults():
    """The JAX package's env knobs are not ported: plain defaults."""
    o = tgraph.GraphSlam2DOptions()
    assert (o.sync_updates, o.live_chunk, o.sync_scans) == (8, 1, 32)
    assert o.slam.transient_map
    assert dataclasses.replace(o, live_chunk=3).live_chunk == 3


def test_trajectory_ring_past_its_capacity(monkeypatch):
    """Past ``Slam2D.TRAJ_CAP`` updates the front end's trajectory is a
    ring (update k at row k % cap): with a ring of 96 rows, whose 64-row
    gate blocks then run past its end, the key poses (update, raw pose)
    equal those of a run whose ring never fills, and ``trajectory()``
    gives the last 96 matched poses, oldest first."""
    cfg = simulator.SimConfig(
        n_steps=200, seed=8,
        laser=simulator.LaserSpec(n_beams=60, max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004)
    data = simulator.simulate(cfg)

    def run():
        gs = tgraph.GraphSlam2D(tgraph.GraphSlam2DOptions(
            slam=Slam2DOptions(resolution=0.1, patch_size=16, max_range=8.0,
                               trans_thresh=0.05, rot_thresh=0.05,
                               capacity=4096, transient_map=True),
            ignore_n_chain_poses=1000, key_pose_distance=0.5),
            device="cpu")
        gs.set_prior(Pose2D(*data.poses_gt[0]))
        for k in range(cfg.n_steps):
            gs.update(data.clouds[k], Pose2D(*data.odometry[k].xyr()),
                      data.timestamps[k])
        kps = gs.key_poses
        return (gs.slam, [kp.timestamp for kp in kps],
                np.array([kp.raw_pose.xyr() for kp in kps]))

    slam, ts, raw = run()
    traj = slam.trajectory()
    monkeypatch.setattr(Slam2D, "TRAJ_CAP", 96)
    ring, ts_ring, raw_ring = run()
    assert ring._n_updates == slam._n_updates > 2 * 96
    assert ts_ring == ts and len(ts) > 8
    np.testing.assert_array_equal(raw_ring, raw)
    np.testing.assert_array_equal(ring.trajectory(), traj[-96:])
