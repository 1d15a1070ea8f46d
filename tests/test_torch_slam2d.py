"""The PyTorch port's Slam2D against the JAX package's, end to end on the CPU.

Config of test_slam2d_e2e.py::test_update_paths_equivalent (0.1 m cells,
16-cell patches, max_range 8, 120 beams padded to 256, 40 steps ~2 m
apart), with ``scroll_kp=5`` so that the run holds both band scrolls and
full re-orgs. One JAX run through ``update_many_prepadded`` is snapshotted
after every scan and shared by the tests of this module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos.slam2d import Slam2D as JSlam2D
from iris_lama_tpu.algos.slam2d import Slam2DOptions as JOptions
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.sdm import mapping as jmap
from iris_lama_tpu.utils import simulator as jsim
from iris_lama_tpu.utils.cloud import beam_bucket, pad_scan
from iris_lama_tpu.utils.evaluation import ate_rmse

from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.match import match_surface_2d as tmatch
from iris_lama_tpu_torch.nlls.solver import SolveResult
from iris_lama_tpu_torch.sdm import mapping as tmap
from iris_lama_tpu_torch.utils import state as tstate

N_STEPS = 40
OPTS = dict(resolution=0.1, patch_size=16, max_range=8.0, trans_thresh=0.2,
            rot_thresh=0.2, capacity=1024, scroll_kp=5)
TABLE = ("keys", "slots", "free_slots", "n_free", "overflow")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_state(slam) -> dict:
    """The JAX Slam2D's map, pose and driver bookkeeping as numpy (the
    layout of iris_lama_tpu_torch.utils.state)."""
    m = slam._map
    d = {f"table_{f}": np.array(getattr(m.table, f)) for f in TABLE}
    d.update(occupied=np.array(m.occupied), visited=np.array(m.visited),
             dist=np.array(m.dist), res_org=np.array(slam._res_org),
             res_occ=np.array(slam._res_occ), res_vis=np.array(slam._res_vis),
             res_dist=np.array(slam._res_dist),
             pose=np.array(slam._pose_dev), odom=slam.odom_.xyr(),
             odom_reorg=slam._odom_reorg.xyr(),
             n_updates=np.int64(slam._n_updates),
             escaped=np.int32(slam.escaped_count()))
    return d


@pytest.fixture(scope="module")
def run():
    data = jsim.simulate(jsim.SimConfig(
        n_steps=N_STEPS, seed=6,
        laser=jsim.LaserSpec(n_beams=120, max_range=8.0)))
    nb = beam_bucket(120)
    padded = [pad_scan(c, nb) for c in data.clouds]
    slam = JSlam2D(JOptions(**OPTS))
    slam.set_prior(JPose2D(*data.poses_gt[0]))
    snaps = []
    step = slam._do_step_od

    def snapshot_step(*args):
        step(*args)
        snaps.append(jax_state(slam))

    slam._do_step_od = snapshot_step
    staged = [tuple(jnp.asarray(a) for a in p) for p in padded]
    accepted = slam.update_many_prepadded(staged, data.odometry)
    assert len(snaps) == len(accepted) - 1     # every scan went per scan
    flushed = jax_state(slam)
    flushed.update({f"table_{f}": np.array(getattr(slam.map.table, f))
                    for f in TABLE})
    flushed.update({k: np.array(getattr(slam.map, k))
                    for k in ("occupied", "visited", "dist")})
    # the replay runs pending scans after the gate has moved on: the
    # odometry a snapshot belongs to is its own scan's
    for snap, k in zip(snaps, accepted[1:]):
        snap["odom"] = data.odometry[k].xyr()
    return dict(data=data, padded=padded, accepted=accepted, snaps=snaps,
                traj=slam.trajectory(), escaped=slam.escaped_count(),
                flushed=flushed,
                first_pose=np.array(slam._traj[0]))


def _port(data):
    slam = Slam2D(Slam2DOptions(**OPTS), device="cpu")
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    return slam


def _staged(padded):
    return [tuple(torch.as_tensor(a) for a in p) for p in padded]


def _assert_pose_close(a, b):
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    assert np.abs(a[:, :2] - b[:, :2]).max() <= 1e-3
    dth = np.angle(np.exp(1j * (a[:, 2] - b[:, 2])))
    assert np.abs(dth).max() <= 1e-3


def _assert_state_equal(slam, want: dict):
    """Resident window and pool (table + cell arrays) bit-equal."""
    got = tstate.slam_to_numpy(slam)
    keys = (["res_org", "res_occ", "res_vis", "res_dist", "occupied",
             "visited", "dist"] + [f"table_{f}" for f in TABLE])
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_slice_end_to_end(run):
    data = run["data"]
    slam = _port(data)
    accepted = slam.update_many_prepadded(_staged(run["padded"]),
                                          data.odometry)
    assert accepted == run["accepted"]
    traj = slam.trajectory()
    _assert_pose_close(traj, run["traj"])
    gt = data.poses_gt[accepted]
    assert abs(ate_rmse(traj, gt) - ate_rmse(run["traj"], gt)) <= 1e-3
    assert slam.escaped_count() == 0 and run["escaped"] == 0
    assert slam.n_scrolls >= 1 and slam.n_reorgs - slam.n_scrolls >= 1


def test_teacher_forced_maps_bit_equal(run, monkeypatch):
    """JAX's matched poses drive the port's map updates, scrolls and
    re-orgs: resident grids and pool bit-equal after every scan."""
    data = run["data"]
    poses = iter([s["pose"] for s in run["snaps"]])

    def forced(*args, **kw):
        state = torch.as_tensor(next(poses))
        zero = torch.zeros(())
        return SolveResult(state, torch.zeros((), dtype=torch.int32), zero,
                           zero, zero)

    monkeypatch.setattr(tmatch, "solve_window", forced)
    slam = _port(data)
    staged = _staged(run["padded"])
    slam.update_prepadded(*staged[0], data.odometry[0])
    np.testing.assert_array_equal(slam._pose_dev.numpy(), run["first_pose"])
    for k, snap in zip(run["accepted"][1:], run["snaps"]):
        assert slam.update_prepadded(*staged[k], data.odometry[k])
        _assert_state_equal(slam, snap)
    assert slam.n_scrolls >= 1 and slam.n_reorgs - slam.n_scrolls >= 1
    slam.map        # flushes the resident window into the pool
    _assert_state_equal(slam, run["flushed"])


def test_update_from_clouds_matches_prepadded(run):
    """``update`` pads the cloud on the host and takes the same path."""
    data = run["data"]
    a, b = _port(data), _port(data)
    staged = _staged(run["padded"])
    for k in range(12):
        assert a.enough_motion(data.odometry[k]) == b.enough_motion(
            data.odometry[k])
        assert a.update(data.clouds[k], data.odometry[k]) == \
            b.update_prepadded(*staged[k], data.odometry[k])
    np.testing.assert_array_equal(a.trajectory(), b.trajectory())
    np.testing.assert_array_equal(a.pose().xyr(), b.pose().xyr())


def test_escape_ladder_then_per_scan_fallback(run):
    """Escapes tighten the re-org trigger, clean checks release it, and
    with no safe trigger left the driver re-orgs on a per-scan safe-zone
    check; re-org timing moves no result."""
    data = run["data"]
    slam = _port(data)
    staged = _staged(run["padded"])
    for k in range(3):
        slam.update_prepadded(*staged[k], data.odometry[k])
    trig = slam._reorg_trigger_m
    slam._esc_dev.fill_(1)
    with pytest.warns(UserWarning, match="tightening"):
        slam._harvest_escapes()
    assert slam._reorg_trigger_m == pytest.approx(trig - 1.0)
    for _ in range(4):                    # four clean checks release it
        slam._harvest_escapes()
    assert slam._reorg_trigger_m == pytest.approx(trig)
    esc = 1
    while slam._host_reorg:
        esc += 1
        slam._esc_dev.fill_(esc)
        with pytest.warns(UserWarning):
            slam._harvest_escapes()
    assert slam._reorg_trigger_m < 0.5
    n0 = slam.n_reorgs
    for k in range(3, 16):
        assert slam.update_prepadded(*staged[k], data.odometry[k])
    assert slam.n_reorgs > n0 and slam.escaped_count() == esc
    _assert_pose_close(slam.trajectory(), run["traj"][:16])


def test_host_reorg_off_matches_jax_device_check(run):
    """``host_reorg=False``: the per-scan safe-zone check and re-org
    (the JAX package's device-cond step) on both sides."""
    data = run["data"]
    opts = dict(OPTS, host_reorg=False)
    j = JSlam2D(JOptions(**opts))
    j.set_prior(JPose2D(*data.poses_gt[0]))
    t = Slam2D(Slam2DOptions(**opts), device="cpu")
    t.set_prior(Pose2D(*data.poses_gt[0]))
    staged = _staged(run["padded"])
    for k in range(24):
        p, m, o = run["padded"][k]
        assert j.update_prepadded(jnp.asarray(p), jnp.asarray(m),
                                  jnp.asarray(o), data.odometry[k]) == \
            t.update_prepadded(*staged[k], data.odometry[k])
    assert t.n_reorgs >= 2 and not t._host_reorg
    _assert_pose_close(t.trajectory(), j.trajectory())
    np.testing.assert_array_equal(t._res_org.numpy(), np.asarray(j._res_org))


@pytest.mark.parametrize("at", [4, 17, 30])
def test_state_carried_across(run, at):
    """Load the JAX Slam2D's state after scan ``at`` into the port, step
    once on both and compare."""
    data = run["data"]
    slam = Slam2D(Slam2DOptions(**OPTS), device="cpu")
    snap = run["snaps"][at]
    slam.load_state_dict(snap)
    _assert_state_equal(slam, snap)
    k = run["accepted"][at + 2]
    assert slam.update_prepadded(*_staged([run["padded"][k]])[0],
                                 data.odometry[k])
    want = run["snaps"][at + 1]
    got_pose = slam.pose().xyr()
    want_pose = JPose2D.from_se2_array(want["pose"]).xyr()
    _assert_pose_close(got_pose, want_pose)
    _assert_state_equal(slam, want)


# ---------------------------------------------------------------------------
# the resident-window functions on the same grids and pose
# ---------------------------------------------------------------------------

def _cfgs():
    return (JOptions(**OPTS).mapping_config(),
            Slam2DOptions(**OPTS).mapping_config())


def _jmap_state(d):
    from iris_lama_tpu.sdm.pool import PatchTable
    return jmap.SlamMapState(
        PatchTable(*(jnp.asarray(d[f"table_{f}"]) for f in TABLE)),
        jnp.asarray(d["occupied"]), jnp.asarray(d["visited"]),
        jnp.asarray(d["dist"]))


def _grids(d, which):
    j = tuple(jnp.asarray(d[k]) for k in which)
    t = tuple(torch.as_tensor(d[k]).to(torch.int32 if d[k].dtype == np.uint16
                                       else torch.as_tensor(d[k]).dtype)
              for k in which)
    return j, t


def _map_equal(tm, jm):
    got = tstate.map_to_numpy(tm)
    for f in TABLE:
        np.testing.assert_array_equal(got[f"table_{f}"],
                                      np.asarray(getattr(jm.table, f)))
    for k in ("occupied", "visited", "dist"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jm, k)))


RES = ("res_occ", "res_vis", "res_dist")


@pytest.mark.parametrize("at", [6, 21])
def test_resident_update_bit_exact(run, at):
    jcfg, tcfg = _cfgs()
    snap, nxt = run["snaps"][at], run["snaps"][at + 1]
    k = run["accepted"][at + 2]
    p, m, o = run["padded"][k]
    (jo, jv, jd), (to, tv, td) = _grids(snap, RES)
    fn = jax.jit(functools.partial(jmap.resident_update, jcfg))
    want = fn(jnp.asarray(snap["res_org"]), jo, jv, jd,
              jnp.asarray(nxt["pose"]), p, m, o)
    got = tmap.resident_update(tcfg, torch.as_tensor(snap["res_org"]), to, tv,
                               td, torch.as_tensor(nxt["pose"]),
                               torch.as_tensor(p), torch.as_tensor(m),
                               torch.as_tensor(o))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("at", [6, 21])
def test_resident_flush_gather_bit_exact(run, at):
    jcfg, tcfg = _cfgs()
    snap = run["snaps"][at]
    (jo, jv, jd), (to, tv, td) = _grids(snap, RES)
    org = snap["res_org"]
    jm = jax.jit(functools.partial(jmap.resident_flush, cfg=jcfg))(
        _jmap_state(snap), org=jnp.asarray(org), occ=jo, vis=jv, dist=jd)
    tm = tmap.resident_flush(tstate.map_from_numpy(snap, "cpu"), tcfg,
                             torch.as_tensor(org), to, tv, td)
    _map_equal(tm, jm)
    # regather one patch diagonally away from the flushed window
    new_org = org + np.array([16, -16], np.int32)
    want = jax.jit(functools.partial(jmap.resident_gather, cfg=jcfg))(
        jm, org=jnp.asarray(new_org))
    got = tmap.resident_gather(tm, tcfg, torch.as_tensor(new_org))
    for g, w in zip(got, want):
        assert g.dtype in (torch.int32, torch.int8)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shift", [(5, 0), (-3, 2), (1, -5)])
def test_resident_scroll_bit_exact(run, shift):
    jcfg, tcfg = _cfgs()
    kp = 5
    snap = run["snaps"][12]
    (jo, jv, jd), (to, tv, td) = _grids(snap, RES)
    org = snap["res_org"]
    new_org = (org + np.asarray(shift, np.int32) * 16).astype(np.int32)
    fn = jax.jit(functools.partial(jmap.resident_scroll, cfg=jcfg, kp=kp))
    jm, *jg = fn(_jmap_state(snap), org=jnp.asarray(org), occ=jo, vis=jv,
                 dist=jd, new_org=jnp.asarray(new_org))
    tm, *tg = tmap.resident_scroll(tstate.map_from_numpy(snap, "cpu"), tcfg,
                                   torch.as_tensor(org), to, tv, td,
                                   torch.as_tensor(new_org), kp)
    _map_equal(tm, jm)
    for g, w in zip(tg, jg):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
