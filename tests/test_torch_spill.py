"""The port's host spill tier (iris_lama_tpu_torch/sdm/spill.py) and
Slam2D's ``use_compression`` against the JAX package, on the CPU.

* extract and inject on a state carried across from JAX: blocks, tables,
  ``present`` and ``droppable`` bit-equal; counts near 65535 survive a
  spill and a refill;
* blobs byte-equal to the JAX package's ``_pack``, and each package
  unpacks the other's;
* tests/test_spill.py's Slam2D runs on the port (0.1 m cells, 8-cell
  patches, 120 beams, capacity 160 against 2,048), over the first
  ``PORT_SCANS`` scans of its route, by which every event has fired:
  overflow only without the tier; spills, refills and cache hits fire;
  the trajectory and ``full_map`` bit-equal to the unbounded run;
* the port's spill run against JAX's: the same accepted scans, spill and
  refill counts, trajectories within 1e-4 m / rad, up to the scan where
  the free runs part (``PART_AT``); and a JAX driver with patches in its
  store carried into the port at ``CARRY_AT`` goes on as JAX does, counts
  equal after every scan, up to the next parting (``CARRY_END``).

The partings: at scan 96 one update from JAX's exact state lands 1.08 mm
from JAX's pose after the same three IRLS steps (a near-singular normal
matrix turns the summation order's ulps into a millimetre), and the next
scan's match falls 3.4 cm apart; the carried run parts the same way at
scan 204. The spill tier follows the poses: its counts stay equal while
the poses do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos.slam2d import Slam2D as JSlam2D
from iris_lama_tpu.algos.slam2d import Slam2DOptions as JOptions
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.sdm import mapping as jmap
from iris_lama_tpu.sdm import pool as jpool
from iris_lama_tpu.sdm import spill as jspill
from iris_lama_tpu.sdm.geometry import MapGeometry as JGeo
from iris_lama_tpu.utils import simulator as jsim

from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.sdm import io as tio
from iris_lama_tpu_torch.sdm import mapping as tmap
from iris_lama_tpu_torch.sdm import pool as tpool
from iris_lama_tpu_torch.sdm import spill as tspill
from iris_lama_tpu_torch.sdm.geometry import MapGeometry as TGeo
from iris_lama_tpu_torch.utils import state as tstate

N_STEPS = 240       # the simulated route (tests/test_spill.py's)
PORT_SCANS = 160    # the port's own runs: every event has fired by then
PART_AT = 96        # the free runs agree on the scans before this one
CARRY_AT = 160      # the JAX run's scan at which it is carried to the port
CARRY_END = 204     # ... and the carried run agrees up to this one
SPILL_OPTS = dict(resolution=0.1, patch_size=8, max_range=3.0, l2_max=0.3,
                  trans_thresh=0.15, rot_thresh=0.15, pose_slack=0.5,
                  max_iter=30)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    kw = dict(max_range=3.0, pose_slack=0.5, capacity=64)
    return (jmap.MappingConfig(geometry=JGeo(0.1, 3, False), **kw),
            tmap.MappingConfig(geometry=TGeo(0.1, 3, False), **kw))


def _jax_state(cfg, blocks):
    """A JAX map holding ``blocks``: {key: (occ, vis, dist)}."""
    st = jmap.slam_map_init(cfg)
    keys = jnp.asarray(list(blocks), jnp.int32)
    table, slots = jpool.table_insert(st.table, keys)
    occ, vis, dist = st.occupied, st.visited, st.dist
    for (o, v, d), s in zip(blocks.values(), np.asarray(slots)):
        occ = occ.at[s].set(jnp.asarray(o, occ.dtype))
        vis = vis.at[s].set(jnp.asarray(v, vis.dtype))
        dist = dist.at[s].set(jnp.asarray(d, jnp.float32))
    return st._replace(table=table, occupied=occ, visited=vis, dist=dist)


def _blocks(rng, keys, length=8):
    """Random patches with counts near 65535."""
    return {k: (rng.integers(65000, 65536, (length, length)),
                rng.integers(65000, 65536, (length, length)),
                rng.uniform(0.0, 0.3, (length, length)).astype(np.float32))
            for k in keys}


def _assert_maps_equal(got, want):
    g, w = tstate.map_to_numpy(got), tstate.map_to_numpy(want)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_extract_inject_match_jax():
    jc, tc = _cfgs()
    rng = np.random.default_rng(3)
    jst = _jax_state(jc, _blocks(rng, (100, 200, 300, 4000)))
    tst = tstate.map_from_numpy(tstate.map_to_numpy(jst), "cpu")
    keys = np.array([200, 300, 999, -1, 4000], np.int32)

    want = jspill.extract_patches(jst, jc, jnp.asarray(keys))
    got = tspill.extract_patches(tst, tc, keys)
    _assert_maps_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[4].numpy(),
                                  [True, True, False, False, True])

    # inject into a map that already holds key 200 (its block is newer)
    other = _jax_state(jc, _blocks(np.random.default_rng(4), (200,)))
    tother = tstate.map_from_numpy(tstate.map_to_numpy(other), "cpu")
    jin, jdrop = jspill.inject_patches(other, jc, jnp.asarray(keys),
                                       *want[1:4])
    tin, tdrop = tspill.inject_patches(tother, tc, keys, *got[1:4])
    _assert_maps_equal(tin, jin)
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))
    np.testing.assert_array_equal(tdrop.numpy(),
                                  [True, True, True, False, True])


def test_batch_forms_match_jax():
    """The particle-axis forms on three pools carried across: one shared
    victim list out, per-particle key lists back in."""
    import jax
    jc, tc = _cfgs()
    rng = np.random.default_rng(8)
    parts = [_jax_state(jc, _blocks(rng, ks))
             for ks in ((100, 200), (200, 300, 400), (500,))]
    jmaps = jax.tree.map(lambda *a: jnp.stack(a), *parts)
    d = tstate.map_to_numpy(jmaps)
    tmaps = tstate.map_from_numpy(d, "cpu")
    np.testing.assert_array_equal(
        tspill.snapshot_keys_batch(tmaps.table).numpy(),
        np.asarray(jspill.snapshot_keys_batch(jmaps.table)))
    keys = np.array([200, 400, 500, -1], np.int32)
    want = jspill.extract_patches_batch(jmaps, jc, jnp.asarray(keys))
    got = tspill.extract_patches_batch(tmaps, tc, keys)
    _assert_maps_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = np.where(got[4].numpy(), keys[None, :], -1).astype(np.int32)
    jin, jdrop = jspill.inject_patches_batch(want[0], jc, jnp.asarray(back),
                                             *want[1:4])
    tin, tdrop = tspill.inject_patches_batch(got[0], tc, back, *got[1:4])
    _assert_maps_equal(tin, jin)
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))
    assert tdrop.numpy().sum() == 4 and bool(got[4].numpy()[2, 2])


def test_counts_near_65535_survive_spill_and_refill():
    """A patch spilled to blobs and refilled into the pool it left comes
    back with its counts (up to 65535) and meters unchanged."""
    _, tc = _cfgs()
    rng = np.random.default_rng(5)
    blocks = _blocks(rng, (7, 8, 9))
    blocks[7][0][0, 0] = blocks[7][1][0, 0] = 65535
    st0 = tstate.map_from_numpy(tstate.map_to_numpy(
        _jax_state(_cfgs()[0], blocks)), "cpu")
    store = tspill.HostSpillStore(tc, tc.geometry)
    keys = np.array([7, 9], np.int32)
    st, occ, vis, dist, present = tspill.extract_patches(st0, tc, keys)
    assert int(st.table.num_patches()) == 1
    blobs = [store._pack_blocks(occ[i].numpy(), vis[i].numpy(),
                                dist[i].numpy()) for i in range(2)]
    k, o, v, d = store._upload(keys, blobs, "cpu")
    st, drop = tspill.inject_patches(st, tc, k, o, v, d)
    assert bool(drop.all()) and int(st.table.num_patches()) == 3
    slots = tpool.table_lookup(st.table, torch.as_tensor(keys)).long()
    for i, key in enumerate(keys):
        o_, v_, d_ = blocks[int(key)]
        np.testing.assert_array_equal(st.occupied[slots[i]].numpy(), o_)
        np.testing.assert_array_equal(st.visited[slots[i]].numpy(), v_)
        np.testing.assert_array_equal(st.dist[slots[i]].numpy(), d_)
    assert int(st.visited[slots[0], 0, 0]) == 65535


def test_blobs_match_jax():
    jc, tc = _cfgs()
    js = jspill.HostSpillStore(jc, jc.geometry)
    ts = tspill.HostSpillStore(tc, tc.geometry)
    rng = np.random.default_rng(6)
    occ = rng.integers(0, 65536, (8, 8)).astype(np.int32)
    occ[:4] = 0                      # compressible rows
    vis = np.maximum(occ, rng.integers(0, 9, (8, 8))).astype(np.int32)
    dist = rng.uniform(0, 0.3, (8, 8)).astype(np.float32)
    jblob = js._pack(occ.astype(np.uint16).tobytes(),
                     vis.astype(np.uint16).tobytes(), dist.tobytes())
    tblob = ts._pack_blocks(occ, vis, dist)
    assert tblob == jblob
    for blob in (jblob, tblob):
        for store in (js, ts):
            o, v, d = store._unpack(blob)
            np.testing.assert_array_equal(o, occ)
            np.testing.assert_array_equal(v, vis)
            np.testing.assert_array_equal(d, dist)


def _data():
    return jsim.simulate(jsim.SimConfig(
        n_steps=N_STEPS, seed=4,
        laser=jsim.LaserSpec(n_beams=120, max_range=3.0)))


def _port_run(data, use_compression, capacity):
    slam = Slam2D(Slam2DOptions(**SPILL_OPTS, capacity=capacity,
                                use_compression=use_compression),
                  device="cpu")
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    acc = [k for k in range(PORT_SCANS)
           if slam.update(data.clouds[k], data.odometry[k],
                          data.timestamps[k])]
    return slam, acc


@pytest.fixture(scope="module")
def runs():
    data = _data()
    out = {name: _port_run(data, uc, cap) for name, uc, cap in (
        ("plain", False, 160), ("spill", True, 160), ("big", False, 2048))}
    # the JAX spill run up to CARRY_END, carried to a fresh port driver at
    # CARRY_AT; the pose and counts after every scan
    j = JSlam2D(JOptions(**SPILL_OPTS, capacity=160, use_compression=True))
    j.set_prior(JPose2D(*data.poses_gt[0]))
    jacc, jlog = [], []
    for k in range(CARRY_END):
        if k == CARRY_AT:
            carried = tstate.slam_to_numpy(j)
        if j.update(data.clouds[k], data.odometry[k], data.timestamps[k]):
            jacc.append(k)
        jlog.append((np.asarray(j.pose().xyr()), _counts(j._spill)))
    out["jax"] = (j, jacc, jlog)
    t = Slam2D(Slam2DOptions(**SPILL_OPTS, capacity=160,
                             use_compression=True), device="cpu")
    tstate.slam_from_numpy(t, carried)
    tlog = []
    for k in range(CARRY_AT, CARRY_END):
        t.update(data.clouds[k], data.odometry[k], data.timestamps[k])
        tlog.append((t.pose().xyr(), _counts(t._spill)))
    out["carried"] = (t, tlog, carried)
    return out


def _counts(sp):
    return sp.spills, sp.refills, sp.cache_hit


def _active_content(state):
    keys, mask = tpool.active_keys(state.table)
    keys = keys[mask]
    slots = tpool.table_lookup(state.table, keys).long()
    return {int(k): (state.occupied[s], state.visited[s], state.dist[s])
            for k, s in zip(keys, slots)}


def test_slam_spill_is_unbounded(runs, tmp_path):
    plain, spill, big = (runs[k][0] for k in ("plain", "spill", "big"))
    assert int(plain.map.table.overflow) > 0
    assert int(spill.map.table.overflow) == 0
    assert int(big.map.table.overflow) == 0
    sp = spill._spill
    assert sp.spills > 0 and sp.refills > 0 and sp.cache_hit > 0
    assert sp.memory_usage() > 0 and len(sp.store) > 0
    assert runs["spill"][1] == runs["big"][1]
    # exact: the bounded run is the unbounded run, bit for bit
    np.testing.assert_array_equal(spill.trajectory(), big.trajectory())
    merged, want = _active_content(spill.full_map()), _active_content(big.map)
    assert set(merged) == set(want)
    for k in want:
        for g, w in zip(merged[k], want[k]):
            assert torch.equal(g, w), k
    # the merged map goes through a .smd file with every patch
    path = str(tmp_path / "merged.smd")
    full = spill.full_map()
    tio.write_distance_map(full, spill.cfg.geometry, spill.cfg.l2_max, path)
    back, _ = tio.read_distance_map(path, device="cpu")
    assert (int(back.table.num_patches())
            > int(spill.map.table.num_patches()))


def _assert_close(a, b):
    """Poses (x, y, theta) within 1e-4 m / rad (the bounds of
    tests/test_torch_transient.py::test_slam2d_options_match_jax)."""
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    assert np.abs(a[:, :2] - b[:, :2]).max() <= 1e-4
    assert np.abs(np.angle(np.exp(1j * (a[:, 2] - b[:, 2])))).max() <= 1e-4


def test_slam_spill_matches_jax(runs):
    """The free runs: the same accepted scans; before PART_AT, poses within
    1e-4 m / rad and the same spill and refill counts and cache hits."""
    spill, acc = runs["spill"]
    _, jacc, jlog = runs["jax"]
    assert acc == jacc[:len(acc)]
    traj = spill.trajectory()
    _assert_close(traj[:PART_AT], [p for p, _ in jlog[:PART_AT]])
    # the free runs part at PART_AT (module docstring)
    assert np.abs(traj[PART_AT + 1, :2] - jlog[PART_AT + 1][0][:2]).max() \
        > 1e-2
    # the tier's events over the prefix, replayed on the port's trajectory
    prefix = Slam2D(spill.options, device="cpu")
    data = _data()
    prefix.set_prior(Pose2D(*data.poses_gt[0]))
    for k in range(PART_AT):
        prefix.update(data.clouds[k], data.odometry[k])
    assert _counts(prefix._spill) == jlog[PART_AT - 1][1]
    assert prefix._spill.spills >= 1


def test_spill_state_carried_from_jax(runs):
    """A JAX driver with patches in its store, carried into the port at
    scan CARRY_AT: after every scan up to CARRY_END the same pose within
    1e-4 m / rad and the same spill, refill and cache-hit counts (all of
    which fire), and at the end the same stored keys."""
    t, tlog, carried = runs["carried"]
    j, _, jlog = runs["jax"]
    assert len(carried["spill_keys"]) > 0 and carried["spills"] > 0
    for (p, c), (jp, jc) in zip(tlog, jlog[CARRY_AT:]):
        _assert_close(p, jp)
        assert c == jc
    first, last = jlog[CARRY_AT - 1][1], tlog[-1][1]
    assert all(b > a for a, b in zip(first, last)), (first, last)
    assert sorted(t._spill.store) == sorted(j._spill.store)
    # and the port's own state dict round-trips the store and bookkeeping
    d = tstate.slam_to_numpy(t)
    t2 = Slam2D(t.options, device="cpu")
    tstate.slam_from_numpy(t2, d)
    assert t2._spill.store == t._spill.store
    assert t2._potential == t._potential and t2._check_at == t._check_at
    assert t2._sync_pose.xyr().tolist() == t._sync_pose.xyr().tolist()
