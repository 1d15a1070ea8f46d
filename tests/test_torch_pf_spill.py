"""The port's per-particle spill tier (``PFSlam2DOptions.use_compression``)
on the CPU, at tests/test_pf_spill.py's configuration: 4 particles, 0.1 m
cells, 16-cell patches, 120 beams, the corridor world (its 260 updates
cut to ``N_USE``: the first spill comes at update 175, the first refill
at 220).

* the bounded run (capacity 768, spill tier) equals the unbounded run
  (capacity 4,096, full re-orgs, as the tier takes) bit for bit: poses,
  weights and window origins after every update, resident distance grids,
  the best particle, and every particle's merged map key by key; spills
  and refills fire, no overflow, every pool stays at or below high water;
* the host-gated re-orgs centre where the run without the tier centres
  them: the tier's sync reads the best pose without applying the queued
  motion (the JAX package applies it, ROADMAP queue C);
* a resample follows the first spill before the first refill, so the
  stores must follow the particles through ``spill_lineage``; and, on
  stores that differ per particle, a forced resample and a re-org before
  the settle hand each particle its ancestor's store;
* the merged map goes through a ``.smd`` file with more patches than the
  bounded pool holds;
* ``PFSpillStore.permute`` shares blobs, ``memory_usage`` counts a shared
  blob once;
* against the JAX package: ``spill_batch``, ``refill_batch``,
  ``need_refill``, ``stored_floor``, ``merged_map_particle``, the refill
  window and the keep radius on pools carried across; and a JAX filter
  with patches in its stores carried into the port goes on with the same
  counts and stored keys;
* the state dict carries the stores (shared blobs stay shared), the
  counters, ``spill_lineage`` and the sync bookkeeping: a filter reloaded
  mid-run goes on as the original.
"""

import dataclasses

import numpy as np
import pytest
import torch

from iris_lama_tpu.sdm import spill as jspill
from iris_lama_tpu.utils import simulator as jsim

from iris_lama_tpu_torch.algos import pf_slam2d as tpf
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.sdm import io as tio
from iris_lama_tpu_torch.sdm import pool as tpool
from iris_lama_tpu_torch.sdm import spill as tspill
from iris_lama_tpu_torch.sdm.geometry import PKEY_BITS
from iris_lama_tpu_torch.utils import state as tstate
from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

N_USE = 232
RELOAD_AT = 200     # after the first spill, before the first refill


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opts(**kw):
    base = dict(particles=4, resolution=0.1, patch_size=16, max_range=8.0,
                trans_thresh=0.5, rot_thresh=0.5, max_iter=50, seed=77,
                resident_extra_patches=1)
    base.update(kw)
    return tpf.PFSlam2DOptions(**base)


def _filter(data, opts):
    f = tpf.PFSlam2D(opts, device="cpu")
    f.set_prior(Pose2D(*data.poses_gt[0]))
    return f


@pytest.fixture(scope="module")
def corridor():
    data = jsim.simulate(jsim.SimConfig(
        n_steps=400, seed=4, world="corridor",
        laser=jsim.LaserSpec(n_beams=120, max_range=8.0),
        odom_trans_noise=0.005, odom_rot_noise=0.001))
    nb = beam_bucket(120)
    return data, [tuple(torch.as_tensor(a)
                        for a in pad_scan(data.clouds[k], nb))
                  for k in range(N_USE)]


@pytest.fixture(scope="module")
def runs(corridor):
    """The unbounded run ``a`` (full re-orgs, as the tier takes) and the
    bounded run ``b`` in lockstep, compared after every update; ``c`` is
    ``b`` reloaded from its state dict at RELOAD_AT."""
    data, staged = corridor
    a = _filter(data, _opts(capacity=4096, scroll_reorg=False))
    b = _filter(data, _opts(capacity=768, use_compression=True))
    events = []   # (update, spilled, refilled, resampled)
    parted = None  # the first update after which a and b differ
    for k in range(N_USE):
        if k == RELOAD_AT:
            saved = tstate.pf_to_numpy(b)
        s0, r0 = b._pf_spill.spills, b._pf_spill.refills
        a.update_prepadded(*staged[k], data.odometry[k])
        if b.update_prepadded(*staged[k], data.odometry[k]) and k:
            events.append((k, b._pf_spill.spills > s0,
                           b._pf_spill.refills > r0,
                           bool(b._last_info_dev["resampled"])))
        if parted is None and not all(
                torch.equal(getattr(a.pset, n), getattr(b.pset, n))
                for n in ("pose", "weight", "res_org")):
            parted = k
    a._flush_motion()
    b._flush_motion()
    c = _filter(data, _opts(capacity=768, use_compression=True))
    tstate.pf_from_numpy(c, saved)
    for k in range(RELOAD_AT, N_USE):
        c.update_prepadded(*staged[k], data.odometry[k])
    c._flush_motion()
    return {"a": a, "b": b, "c": c, "events": events, "saved": saved,
            "parted": parted}


def _content(state, max_dist):
    """{key: blocks} of the non-default active patches."""
    keys, mask = tpool.active_keys(state.table)
    out = {}
    for k in keys[mask].tolist():
        s = int(tpool.table_lookup(state.table, torch.tensor([k]))[0])
        blk = (state.occupied[s], state.visited[s], state.dist[s])
        if blk[0].any() or blk[1].any() or bool((blk[2] != max_dist).any()):
            out[k] = blk
    return out


def test_pf_spill_bounded_bit_exact(runs):
    a, b = runs["a"], runs["b"]
    sp = b._pf_spill
    assert sp.spills >= 1 and sp.refills >= 1 and sp.cache_hit > 0
    patches = b.pset.maps.table.num_patches()
    assert int(patches.max()) <= sp.high
    assert int(b.pset.maps.table.overflow.max()) == 0
    assert b.n_scrolls == 0            # no band scrolls under the tier
    assert torch.equal(b.pset.pose, a.pset.pose)
    assert torch.equal(b.pset.weight, a.pset.weight)
    assert torch.equal(b.pset.res_dist, a.pset.res_dist)
    assert a.best_particle_idx() == b.best_particle_idx()
    # every particle's merged map equals its unbounded map, key by key
    max_dist = np.float32(_opts().mapping_config().distance.max_dist)
    for i in range(_opts().particles):
        ca = _content(a.particle_map(i), max_dist)
        mb, _ = b.full_particle_map(i)
        cb = _content(mb, max_dist)
        assert set(ca) == set(cb), i
        for k in ca:
            for x, y in zip(ca[k], cb[k]):
                assert torch.equal(x, y), (i, k)


def test_pf_spill_sync_keeps_reorg_anchor(runs):
    """Host-gated re-orgs run at this configuration (a trigger of 0.8 m,
    a re-org every update), and the tier syncs its pose estimate in the
    same updates, before the re-org. The sync reads the best pose without
    applying the queued motion, so every re-org centres where the run
    without the tier centres it: after every update the two runs hold the
    same poses, weights and window origin. A sync that applies the queue
    first (the JAX package's ``pose()``) moves the anchor of the re-org of
    update 1, and the window origins part there."""
    a, b = runs["a"], runs["b"]
    assert b.options.host_reorg and b._pf_trigger_m >= 0.5
    assert a.n_scrolls == b.n_scrolls == 0
    assert a.n_reorgs == b.n_reorgs >= N_USE // 2
    assert b._pf_spill.host_reads > 0 and b._sync_pose is not None
    assert runs["parted"] is None, runs["parted"]


def test_pf_resample_after_spill(runs):
    """The order that tells the two lineages apart: a spill, then a
    resample, then a refill (the bit-exact test holds the stores attached
    to the right particles through it)."""
    ev = runs["events"]
    first_spill = min(k for k, s, _, _ in ev if s)
    first_refill = min(k for k, _, r, _ in ev if r)
    assert any(first_spill < k < first_refill for k, _, _, rs in ev if rs)
    assert first_spill < RELOAD_AT < first_refill


def test_pf_stores_follow_resample_through_reorg(corridor):
    """Each particle's store holds its own blob; a resample onto particle
    1 composes ``spill_lineage``, a re-org in between leaves it (and
    resets ``lineage``), and the settle hands every particle particle 1's
    store — one blob, shared."""
    data, staged = corridor
    f = _filter(data, _opts(particles=3, capacity=768, use_compression=True))
    f.update_prepadded(*staged[0], data.odometry[0])
    sp = f._pf_spill
    sp.stores = [{7: b"p0"}, {7: b"p1"}, {7: b"p2"}]
    ps = f.pset._replace(weight=torch.tensor([-1e9, 0.0, -1e9]))
    ps, info = tpf.update_step(f.options, ps, torch.tensor(0.5),
                               *staged[1])
    assert bool(info["resampled"])
    ps = tpf.reorg(f.options, ps)
    ones = torch.ones(3, dtype=torch.int32)
    assert torch.equal(ps.spill_lineage, ones)
    assert torch.equal(ps.lineage, torch.arange(3, dtype=torch.int32))
    f.pset = ps
    f._pf_settle_stores()
    assert sp.stores == [{7: b"p1"}] * 3
    assert sp.stores[0][7] is sp.stores[2][7] and sp.memory_usage() == 2
    assert torch.equal(f.pset.spill_lineage,
                       torch.arange(3, dtype=torch.int32))


def test_pf_spill_smd_roundtrip(runs, tmp_path):
    b = runs["b"]
    state, cfg = b.full_particle_map()
    path = str(tmp_path / "pf_merged.smd")
    tio.write_distance_map(state, cfg.geometry, cfg.l2_max, path)
    back, _ = tio.read_distance_map(path, device="cpu")
    n_live = int(b.particle_map(b.best_particle_idx()).table.num_patches())
    assert int(back.table.num_patches()) > n_live


def test_pf_spill_state_reload(runs):
    """A filter saved mid-run with patches in its stores and reloaded into
    a fresh one goes on as the original: particle set and stores equal."""
    b, c, saved = runs["b"], runs["c"], runs["saved"]
    assert len(saved["spill_keys"]) > 0 and saved["spills"] >= 1
    # one blob a (particle, key) entry at most: shared blobs stored once
    assert len(saved["spill_offsets"]) - 1 <= len(saved["spill_keys"])
    for name in ("pose", "weight", "weight_sum", "res_dist", "res_occ",
                 "lineage", "spill_lineage"):
        assert torch.equal(getattr(c.pset, name), getattr(b.pset, name)), \
            name
    assert c._pf_spill.stores == b._pf_spill.stores
    assert c._pf_spill.memory_usage() == b._pf_spill.memory_usage()
    assert ((c._pf_spill.spills, c._pf_spill.refills, c._pf_spill.cache_hit)
            == (b._pf_spill.spills, b._pf_spill.refills,
                b._pf_spill.cache_hit))


def test_pf_store_permute_shares_blobs():
    cfg = _opts(capacity=64, use_compression=True).mapping_config()
    st = tspill.PFSpillStore(cfg, cfg.geometry, 3)
    jst = jspill.PFSpillStore(cfg, cfg.geometry, 3)
    blobs = [bytes([i]) * (10 + i) for i in range(3)]
    for s in (st, jst):
        s.stores[0] = {1: blobs[0], 2: blobs[1]}
        s.stores[2] = {3: blobs[2]}
    assert st.memory_usage() == 10 + 11 + 12
    for s in (st, jst):
        s.permute(np.array([2, 2, 0]))
    assert st.stores == jst.stores
    assert st.stores[0] == st.stores[1] and st.stores[0] is not st.stores[1]
    assert st.stores[0][3] is st.stores[1][3]        # one shared blob
    assert st.memory_usage() == jst.memory_usage() == 12 + 10 + 11
    assert st.stored_floor() == 1
    del st.stores[0][3]                              # the copies are apart
    assert 3 in st.stores[1] and st.stored_floor() == 0


def _patch_keys(geo, cells_xy):
    """Patch keys of the patches whose indices (relative to the patch at
    the world origin) are ``cells_xy``."""
    org = geo.np_w2m(np.zeros(2)) >> geo.log2dim
    p = org[None, :] + np.asarray(cells_xy, np.int64)
    return ((p[:, 0] << PKEY_BITS) | p[:, 1]).astype(np.int32)


def test_pf_store_events_match_jax():
    """PFSpillStore's policy against the JAX package's on three pools
    carried across (capacity 64: high water 51, low water 35): the same
    refill window and keep radius; ``spill_batch`` takes the same smallest
    farthest-first prefix (the same blobs in the same stores, the same
    pools); ``stored_floor``, ``need_refill`` and ``merged_map_particle``
    agree; ``refill_batch`` at the far end brings back each particle's own
    keys into the same pools and leaves the same stores and counters."""
    import jax
    import jax.numpy as jnp
    from iris_lama_tpu.algos import pf_slam2d as jpf
    from test_torch_spill import _assert_maps_equal, _blocks, _jax_state

    kw = dict(capacity=64, use_compression=True)
    topt = _opts(**kw)
    jopt = jpf.PFSlam2DOptions(**{f.name: getattr(topt, f.name)
                                  for f in dataclasses.fields(topt)})
    tc, jc = topt.mapping_config(), jopt.mapping_config()
    ts = tspill.PFSpillStore(tc, tc.geometry, 3)
    js = jspill.PFSpillStore(jc, jc.geometry, 3)
    assert ts._wp_refill == js._wp_refill
    assert ts.keep_radius_m() == js.keep_radius_m()
    xy = np.array([0.3, -0.2])
    np.testing.assert_array_equal(ts.window_keys_np(xy),
                                  js.window_keys_np(xy))

    # a corridor of patches along x (row 0, shared) and a row each particle
    # holds alone; the keep radius is 12 patches, so about half the
    # patches are far
    rows = [[(i, 0) for i in range(-22, 23)] + o for o in (
        [(i, 1) for i in range(-22, -12)], [(i, 1) for i in range(13, 18)],
        [(i, -1) for i in range(-3, 4)])]
    rng = np.random.default_rng(12)
    parts = [_jax_state(jc, _blocks(
        rng, _patch_keys(tc.geometry, r).tolist(), 16)) for r in rows]
    jmaps = jax.tree.map(lambda *a: jnp.stack(a), *parts)
    tmaps = tstate.map_from_numpy(tstate.map_to_numpy(jmaps), "cpu")
    assert ts.stored_floor() == js.stored_floor() == 0

    tmaps, t_any = ts.spill_batch(tmaps, xy)
    jmaps, j_any = js.spill_batch(jmaps, xy)
    assert t_any and j_any
    assert ts.stores == js.stores
    _assert_maps_equal(tmaps, jmaps)
    assert int(tmaps.table.num_patches().max()) <= ts.low
    # the prefix stops short of the far keys: some stay on the device
    union = np.unique(np.concatenate([_patch_keys(tc.geometry, r)
                                      for r in rows]))
    d = np.linalg.norm(ts._key_centers(union) - xy, axis=1)
    assert len(set().union(*ts.stores)) < int((d > ts.keep_radius_m()).sum())
    assert ts.stored_floor() == js.stored_floor() > 0
    assert ts.memory_usage() == js.memory_usage()
    assert not ts.need_refill(xy) and not js.need_refill(xy)

    for i in range(3):
        tone, tcfg = ts.merged_map_particle(tspill._view(tmaps, i), i)
        jone, jcfg = js.merged_map_particle(
            jax.tree.map(lambda a: a[i], jmaps), i)
        assert tcfg.capacity == jcfg.capacity
        _assert_maps_equal(tone, jone)

    far_xy = ts._key_centers(_patch_keys(tc.geometry, [(-14, 0)]))[0]
    assert ts.need_refill(far_xy) and js.need_refill(far_xy)
    tmaps = ts.refill_batch(tmaps, far_xy)
    jmaps = js.refill_batch(jmaps, far_xy)
    _assert_maps_equal(tmaps, jmaps)
    assert ts.stores == js.stores
    assert ((ts.cache_hit, ts.refills, ts.spills)
            == (js.cache_hit, js.refills, js.spills))
    assert ts.refills == 1 and ts.cache_hit > 0


CARRY_CAP = 512     # the JAX run spills at updates 126 and 172
CARRY_AT = 188      # ... and refills at 194, 195 and 197
CARRY_END = 200
SYNC_LEAD = 196     # the port's third refill comes one update earlier


def test_pf_spill_state_carried_from_jax(corridor):
    """A JAX PFSlam2D with patches in its stores (two spills behind it),
    carried into the port at update CARRY_AT and run on the JAX key
    stream: after every update up to CARRY_END the same spill, refill and
    cache-hit counts and every particle's stored keys equal to JAX's. One
    update differs, SYNC_LEAD: the JAX package's sync applies the queued
    motion before it reads the best pose, the port's does not (ROADMAP
    queue C), so the two estimates differ by the motion draw and the
    port's refill window reaches the stored patches one update before
    JAX's; at SYNC_LEAD the port holds JAX's counts and stores of the next
    update."""
    import jax.numpy as jnp
    from iris_lama_tpu.algos import pf_slam2d as jpf
    from iris_lama_tpu.core.pose import Pose2D as JPose2D
    from test_torch_pf_slam2d import JaxDraws, jax_state

    data, staged = corridor
    kw = dict(capacity=CARRY_CAP, use_compression=True)
    topt = _opts(**kw)
    j = jpf.PFSlam2D(jpf.PFSlam2DOptions(**{
        f.name: getattr(topt, f.name) for f in dataclasses.fields(topt)}))
    j.set_prior(JPose2D(*data.poses_gt[0]))

    def log(f):
        sp = f._pf_spill
        return ((sp.spills, sp.refills, sp.cache_hit),
                [sorted(st) for st in sp.stores])

    jlog = {}
    for k in range(CARRY_END):
        if k == CARRY_AT:
            d = jax_state(j)
            d.update(tstate.spill_to_numpy(j, j._pf_spill, j._pf_spill.stores))
            d["spill_lineage"] = np.asarray(j.pset.spill_lineage)
            key = j.key
        j.update_prepadded(*(jnp.asarray(a.numpy()) for a in staged[k]),
                           data.odometry[k])
        if k >= CARRY_AT:
            jlog[k] = log(j)
    assert d["spills"] == 2 and len(d["spill_keys"]) > 0

    t = tpf.PFSlam2D(topt, device="cpu", draws=JaxDraws(key))
    t.set_prior(Pose2D(*data.poses_gt[0]))
    tstate.pf_from_numpy(t, d)
    assert [sorted(st) for st in t._pf_spill.stores] == [
        sorted(d["spill_keys"][d["spill_particle"] == p].tolist())
        for p in range(topt.particles)]
    for k in range(CARRY_AT, CARRY_END):
        t.update_prepadded(*staged[k], data.odometry[k])
        want = jlog[k + 1] if k == SYNC_LEAD else jlog[k]
        assert log(t) == want, k
    assert jlog[SYNC_LEAD] != jlog[SYNC_LEAD + 1]
    assert t._pf_spill.refills == 3 and jlog[CARRY_END - 1][0][1] == 3
