"""The PyTorch port's PFSlam2D against the JAX package's, end to end on the
CPU.

Config of tests/test_pf_slam2d.py::_opts (8 particles, 0.1 m cells,
16-cell patches, max_range 8, 120 beams padded to 128, ``capacity`` 1024,
``max_iter`` 30) with a small resident window (``resident_extra_patches``
2, ``host_reorg_slack`` 0.5) so that a re-org fires every few updates.
Both packages run on the same noise: the port is given the JAX key stream
(one split + normal per odometry packet, one split + uniform per accepted
update).

A free run is chaotic: the port's batched solve (B6) sums the normal
equations in another order than the JAX CPU path's generic solver, and a
particle whose normal matrix is near singular (a corridor, beams off the
window) turns that ulp into a different step. On this trajectory the
eleventh update enters a corridor where several particles take such
steps, so the free run is compared over its first ten updates, and the
map side over a longer run in which the port is fed the JAX run's matched
poses and resample indices (teacher forcing), where it must be
bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos import pf_slam2d as jpf
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.utils import simulator as jsim
from iris_lama_tpu.utils.cloud import beam_bucket, pad_scan

from iris_lama_tpu_torch.algos import pf_slam2d as tpf
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.utils import state as tstate

OPTS = dict(particles=8, resolution=0.1, patch_size=16, max_range=8.0,
            capacity=1024, trans_thresh=0.3, rot_thresh=0.3, max_iter=30,
            seed=3, meas_sigma_gain=1.0, resident_extra_patches=2,
            host_reorg_slack=0.5)
TABLE = ("keys", "slots", "free_slots", "n_free", "overflow")
FREE_UPDATES = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxDraws:
    """The JAX driver's key stream as a draw source for the port."""

    def __init__(self, key):
        self.key = key

    def __call__(self, kind, shape):
        k1, self.key = jax.random.split(self.key)
        if kind == "normal":
            return np.asarray(jax.random.normal(k1, shape))
        return np.asarray(jax.random.uniform(k1))


@pytest.fixture(scope="module")
def data():
    sim = jsim.simulate(jsim.SimConfig(
        n_steps=60, seed=2, laser=jsim.LaserSpec(n_beams=120, max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))
    nb = beam_bucket(120)
    return sim, [pad_scan(c, nb) for c in sim.clouds]


def _pair(sim, **kw):
    """A JAX filter and a port filter (CPU, JAX draws) at one prior."""
    opts = dict(OPTS, **kw)
    j = jpf.PFSlam2D(jpf.PFSlam2DOptions(**opts))
    t = tpf.PFSlam2D(tpf.PFSlam2DOptions(**opts), device="cpu",
                     draws=JaxDraws(jax.random.PRNGKey(opts["seed"])))
    j.set_prior(JPose2D(*sim.poses_gt[0]))
    t.set_prior(Pose2D(*sim.poses_gt[0]))
    return j, t


def _step(f, scan, odom):
    if isinstance(f, jpf.PFSlam2D):
        return f.update_prepadded(*(jnp.asarray(a) for a in scan), odom)
    return f.update_prepadded(*(torch.as_tensor(a) for a in scan), odom)


def _angle(pose):
    return np.arctan2(pose[:, 3], pose[:, 2])


def _assert_filters_agree(j, t, tag):
    jp, tp = np.asarray(j.pset.pose), t.pset.pose.numpy()
    np.testing.assert_allclose(tp[:, :2], jp[:, :2], rtol=0, atol=1e-3,
                               err_msg=tag)
    dth = np.angle(np.exp(1j * (_angle(tp) - _angle(jp))))
    assert np.abs(dth).max() <= 1e-3, (tag, dth)
    # the JAX CPU path sums -d^2 / meas_sigma per beam, the port divides
    # the SSE of the same residuals: equal up to rounding
    np.testing.assert_allclose(t.pset.weight.numpy(),
                               np.asarray(j.pset.weight), rtol=1e-5,
                               atol=1e-4, err_msg=tag)
    np.testing.assert_array_equal(t.pset.lineage.numpy(),
                                  np.asarray(j.pset.lineage), err_msg=tag)
    np.testing.assert_array_equal(t.pset.res_org.numpy(),
                                  np.asarray(j.pset.res_org), err_msg=tag)


@pytest.mark.parametrize("scroll_kp,kinds", [(0, {"scroll"}),
                                             (2, {"full"})])
def test_pf_free_run_matches_jax(data, scroll_kp, kinds):
    """Same scans, same draws: the same scans accepted, every particle's
    pose within 1 mm / 1e-3 rad and its weight within rtol 1e-5 after
    every update, equal lineage, resample flags and window origin, the
    same re-orgs (band scrolls with the automatic band, full re-orgs with
    a 2-patch band), no escapes."""
    sim, padded = data
    j, t = _pair(sim, scroll_kp=scroll_kp)
    updates, resampled, seen = 0, 0, set()
    for k, scan in enumerate(padded):
        n_full = t.n_reorgs - t.n_scrolls
        n_scroll = t.n_scrolls
        accepted = _step(j, scan, sim.odometry[k])
        assert _step(t, scan, sim.odometry[k]) == accepted, k
        if not accepted or k == 0:
            continue
        updates += 1
        ji, ti = j._last_info, t._last_info
        assert t.n_reorgs == j._n_reorgs, k
        seen |= ({"scroll"} if t.n_scrolls > n_scroll else set()) | (
            {"full"} if t.n_reorgs - t.n_scrolls > n_full else set())
        assert ti["resampled"] == ji["resampled"], k
        assert ti["escaped"] == ji["escaped"] == 0, k
        resampled += int(ti["resampled"])
        _assert_filters_agree(j, t, f"update {updates} (scan {k})")
        if updates == FREE_UPDATES:
            break
    assert updates == FREE_UPDATES
    assert resampled >= 1 and seen == kinds, (resampled, seen)


def _pool_arrays(maps):
    d = tstate.map_to_numpy(maps)
    return {k: d[k] for k in d}


def _jax_pool_arrays(maps):
    d = {f"table_{f}": np.asarray(getattr(maps.table, f)) for f in TABLE}
    d.update(occupied=np.asarray(maps.occupied),
             visited=np.asarray(maps.visited), dist=np.asarray(maps.dist))
    return d


def test_pf_teacher_forced_maps_bit_equal(data, monkeypatch):
    """The port's map side fed the JAX run's matched poses, weights and
    resample indices: resident grids, window origin, lineage and every
    particle's pool bit-equal after every update, over a run that holds
    resamples, band scrolls and full re-orgs."""
    sim, padded = data
    j, t = _pair(sim, scroll_kp=3)
    jo = j.options
    teacher = []

    @jax.jit
    def update(pset, key, odeltas, valids, pts, msk, org):
        # the JAX driver's update program (_make_programs.update with
        # host-gated re-orgs), phase by phase, keeping the match results
        # and the resample
        pose, key = jpf._motion_scan(jo, pset.pose, key, odeltas, valids)
        k1, k2 = jax.random.split(key)
        pset = pset._replace(pose=pose)
        mid, states, liks, iters, _ = jpf._pf_match_phase(
            jo, pset, pts, msk, use_cond=False)
        res = jpf._weights_and_resample(jo, pset, k1, states, liks)
        idx, pose, weight, weight_sum, nw, neff, do = res
        mid, sl = jpf._pf_resample_phase(jo, pset, mid, idx, do)
        maps, org_, occ, vis, dist, lineage = mid
        occ, vis, dist = jpf._pf_map_phase(jo, org_, occ, vis, dist, pose,
                                           pts, msk, org)
        new = jpf.ParticleSet(pose, weight, weight_sum, nw, maps, org_, occ,
                              vis, dist, lineage, sl)
        return new, {"resampled": do}, k2, (states, liks, iters, res)

    def recording_update(*args):
        new, info, key, rec = update(*args)
        teacher.append(rec)
        return new, info, key

    j._build()
    j._jit_update = recording_update

    def forced_match(opts, pset, points, mask):
        states, liks, iters, _ = teacher[-1]
        return (torch.as_tensor(np.asarray(states)),
                torch.as_tensor(np.asarray(liks)),
                torch.as_tensor(np.asarray(iters)))

    def forced_resample(opts, weight, weight_sum, states, liks, u):
        return tuple(torch.as_tensor(np.asarray(a)) for a in teacher[-1][3])

    monkeypatch.setattr(tpf, "match_phase", forced_match)
    monkeypatch.setattr(tpf, "weights_and_resample", forced_resample)
    kinds, resampled = set(), 0
    for k, scan in enumerate(padded[:40]):
        n_full, n_scroll = t.n_reorgs - t.n_scrolls, t.n_scrolls
        accepted = _step(j, scan, sim.odometry[k])
        assert _step(t, scan, sim.odometry[k]) == accepted, k
        if not accepted:
            continue
        assert t.n_reorgs == j._n_reorgs, k
        kinds |= ({"scroll"} if t.n_scrolls > n_scroll else set()) | (
            {"full"} if t.n_reorgs - t.n_scrolls > n_full else set())
        if k:
            resampled += int(t._last_info["resampled"])
        jp, tp = j.pset, t.pset
        np.testing.assert_array_equal(tp.res_org.numpy(),
                                      np.asarray(jp.res_org))
        np.testing.assert_array_equal(tp.lineage.numpy(),
                                      np.asarray(jp.lineage))
        for name in ("res_occ", "res_vis", "res_dist"):
            np.testing.assert_array_equal(
                getattr(tp, name).numpy(),
                np.asarray(getattr(jp, name)).astype(
                    getattr(tp, name).numpy().dtype), err_msg=f"{k} {name}")
        got, want = _pool_arrays(tp.maps), _jax_pool_arrays(jp.maps)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"{k} pool {name}")
    assert resampled >= 1 and kinds == {"scroll", "full"}, (resampled,
                                                           kinds)
    # the best particle's map: its pool (through the lineage) with its
    # resident grids flushed in
    i = j.best_particle_idx()
    assert t.best_particle_idx() == i
    got = _pool_arrays(t.particle_map(i))
    want = _jax_pool_arrays(j.particle_map(i))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ---------------------------------------------------------------------------
# state carried across
# ---------------------------------------------------------------------------

def jax_state(j) -> dict:
    """The JAX filter's particle set and bookkeeping in the layout of
    iris_lama_tpu_torch.utils.state."""
    ps = jax.device_get(j.pset)
    d = _jax_pool_arrays(ps.maps)
    for k in ("pose", "weight", "weight_sum", "normalized", "res_org",
              "res_occ", "res_vis", "res_dist", "lineage"):
        d[k] = np.asarray(getattr(ps, k))
    d.update(odom=j.odom_.xyr(), odom_reorg=j._odom_reorg.xyr(),
             acc_trans=np.float64(j.acc_trans),
             acc_rot=np.float64(j.acc_rot),
             odelta_queue=np.asarray(j._odelta_queue,
                                     np.float32).reshape(-1, 4))
    return d


def _load(snap, key):
    t = tpf.PFSlam2D(tpf.PFSlam2DOptions(**OPTS), device="cpu",
                     draws=JaxDraws(key))
    t.load_state_dict(snap)
    back = t.state_dict()
    assert set(back) - set(snap) <= set(tstate.PF_DRIVER)
    assert set(snap) <= set(back)
    for name, a in snap.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
        assert back[name].dtype == np.asarray(a).dtype, name
    return t


def test_pf_state_carried_across(data):
    """A JAX filter snapshotted after three updates (a band scroll behind
    it) and loaded into the port continues like it: the next update, which
    resamples, agrees on both as in the free run. A snapshot after that
    resample (a lineage not settled) gives every particle's map bit-equal.
    State dicts round-trip bit for bit, in the JAX package's dtypes."""
    sim, padded = data
    j, _ = _pair(sim)
    k, updates = 0, 0
    while updates < 3:
        updates += bool(_step(j, padded[k], sim.odometry[k]) and k)
        k += 1
    t = _load(jax_state(j), j.key)
    assert t._pf_trigger_m == j._pf_trigger_m
    assert t._pf_scroll_m == j._pf_scroll_m
    while True:
        acc = _step(j, padded[k], sim.odometry[k])
        assert _step(t, padded[k], sim.odometry[k]) == acc
        k += 1
        if acc:
            break
    assert t._last_info["resampled"] == j._last_info["resampled"] == 1
    _assert_filters_agree(j, t, "after load")

    lineage = np.asarray(j.pset.lineage)
    assert not np.array_equal(lineage, np.arange(8))
    u = _load(jax_state(j), j.key)
    for i in {j.best_particle_idx(), int(np.argmax(lineage != np.arange(8)))}:
        got = _pool_arrays(u.particle_map(i))
        want = _jax_pool_arrays(j.particle_map(i))
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"{i} {name}")

    # the port's own state dict into two fresh filters: equal continuations
    v = _load(u.state_dict(), j.key)
    for f in (u, v):
        for kk in range(k, k + 4):
            _step(f, padded[kk], sim.odometry[kk])
    for name, a in u.state_dict().items():
        np.testing.assert_array_equal(v.state_dict()[name], a, err_msg=name)


def test_pf_state_resumes_draws_and_ladder(data):
    """A port filter on its own draws, reloaded from its state dict into a
    filter of another seed, continues the run it was saved from: the same
    draws, escape ladder, trigger and counts, so both end bit-equal."""
    sim, padded = data
    opts = dict(OPTS, seed=5)
    f = tpf.PFSlam2D(tpf.PFSlam2DOptions(**opts), device="cpu")
    f.set_prior(Pose2D(*sim.poses_gt[0]))
    k = 0
    while f.n_reorgs == 0:
        _step(f, padded[k], sim.odometry[k])
        k += 1
    with pytest.warns(UserWarning, match="strike 1/3"):
        f._pf_harvest_escapes(opts["particles"])
    snap = f.state_dict()
    g = tpf.PFSlam2D(tpf.PFSlam2DOptions(**dict(opts, seed=6)),
                     device="cpu")
    g.load_state_dict(snap)
    for name in tstate.PF_DRIVER:
        np.testing.assert_array_equal(g.state_dict()[name], snap[name],
                                      err_msg=name)
    assert g._esc_strikes == 1 and g.n_reorgs == f.n_reorgs >= 1
    for kk in range(k, k + 4):
        assert _step(f, padded[kk], sim.odometry[kk]) == _step(
            g, padded[kk], sim.odometry[kk])
    got, want = g.state_dict(), f.state_dict()
    assert set(got) == set(want)
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)


# ---------------------------------------------------------------------------
# escape ladder (the cases of tests/test_escape_guard.py)
# ---------------------------------------------------------------------------

def _guarded():
    opts = tpf.PFSlam2DOptions(particles=30, resolution=0.1, patch_size=16,
                               max_range=8.0, capacity=1024, seed=7,
                               resident_extra_patches=2)
    pf = tpf.PFSlam2D(opts, device="cpu")
    pf.set_prior(Pose2D(0.0, 0.0, 0.0))
    assert pf._pf_trigger_m > 0.5     # host-gated re-orgs active
    return pf


def _burst(pf, n, esc=20):
    with pytest.warns(UserWarning):
        for _ in range(n):
            pf._pf_harvest_escapes(esc)


def test_escape_tolerated_tail_changes_nothing():
    pf = _guarded()
    t0 = pf._pf_trigger_m
    for _ in range(10):
        pf._pf_harvest_escapes(max(1, int(0.25 * pf.options.particles)))
    assert pf._pf_trigger_m == t0 and pf.options.host_reorg


def test_escape_burst_strikes_then_escalation():
    pf = _guarded()
    t0 = pf._pf_trigger_m
    with pytest.warns(UserWarning, match="strike 1/3"):
        pf._pf_harvest_escapes(20)
    with pytest.warns(UserWarning, match="strike 2/3"):
        pf._pf_harvest_escapes(20)
    assert pf._pf_trigger_m == t0
    with pytest.warns(UserWarning, match="tightening"):
        pf._pf_harvest_escapes(20)
    assert pf._pf_trigger_m < t0


def test_escape_clean_harvests_recover_trigger():
    pf = _guarded()
    t0 = pf._pf_trigger_m
    _burst(pf, 3)
    tightened = pf._pf_trigger_m
    assert tightened < t0
    for _ in range(4):
        pf._pf_harvest_escapes(0)
    assert tightened < pf._pf_trigger_m <= t0


def test_escape_scroll_deadline_tracks_trigger():
    pf = _guarded()
    assert pf._pf_scroll_m > 0
    _burst(pf, 3)
    assert pf._pf_scroll_m == pf._pf_trigger_m


def test_escape_persistent_bursts_fall_back_to_safe_check(data):
    """Forty bursts exhaust the trigger: the driver falls back to a
    safe-zone check of every particle before each update, which then runs
    like the JAX package's device-cond step."""
    pf = _guarded()
    with pytest.warns(UserWarning):
        for _ in range(40):
            if not pf.options.host_reorg:
                break
            pf._pf_harvest_escapes(20)
    assert not pf.options.host_reorg

    sim, padded = data
    j, t = _pair(sim, host_reorg=False)
    assert not j.options.host_reorg and not t.options.host_reorg
    updates = 0
    for k, scan in enumerate(padded):
        accepted = _step(j, scan, sim.odometry[k])
        assert _step(t, scan, sim.odometry[k]) == accepted, k
        if accepted and k:
            updates += 1
            _assert_filters_agree(j, t, f"update {updates}")
            if updates == FREE_UPDATES:
                break
    assert t.n_reorgs >= 1     # the safe-zone check re-orged


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("use_compression", True), ("create_summary", True),
    ("detailed_summary", True), ("resident_window", False),
    ("reorg_chunk", 4), ("reorg_chunk", 0)])
def test_pf_unported_options_raise(field, value):
    """A ``reorg_chunk`` other than -1 is not ported and raises. The other
    options are ported: the filter builds on the CPU and maps a first scan
    with the option on (``resident_window=False`` into every particle's
    pool, with no resident grids)."""
    opts = tpf.PFSlam2DOptions(capacity=16, **{field: value})
    if field == "reorg_chunk":
        with pytest.raises(NotImplementedError):
            tpf.PFSlam2D(opts, device="cpu")
        return
    if field == "detailed_summary":
        opts = dataclasses.replace(opts, create_summary=True)
    sim = jsim.simulate(jsim.SimConfig(
        n_steps=2, seed=2, laser=jsim.LaserSpec(n_beams=60, max_range=4.0)))
    f = tpf.PFSlam2D(dataclasses.replace(
        opts, particles=3, resolution=0.1, patch_size=16, max_range=4.0,
        capacity=256), device="cpu")
    assert f.update(sim.clouds[0], sim.odometry[0])
    if field == "resident_window":
        assert f.pset.res_org is None and f.pset.lineage is None
        patches = f.pset.maps.table.num_patches()
        assert int(patches[0]) > 0 and torch.equal(patches, patches[:1]
                                                   .expand(3))
    elif field == "use_compression":
        assert f._pf_spill is not None and f.n_scrolls == 0
        assert torch.equal(f.pset.spill_lineage.long(), torch.arange(3))
        assert int(f.pset.res_occ[0].sum()) > 0
    else:
        assert len(f.summary.time_total) == 1 and f.memory_usage() >= 0


def test_pf_entry_point_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpf.PFSlam2D(tpf.PFSlam2DOptions(capacity=16))
    tpf.PFSlam2D(tpf.PFSlam2DOptions(capacity=16), device="cpu")


def test_pf_options_defaults_match_jax():
    """The port's options carry the JAX defaults as plain values."""
    jf = {f.name: f.default for f in dataclasses.fields(jpf.PFSlam2DOptions)}
    for f in dataclasses.fields(tpf.PFSlam2DOptions):
        assert f.default == jf[f.name], f.name
