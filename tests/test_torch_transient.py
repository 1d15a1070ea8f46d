"""The port's pool removals, probabilistic occupancy, pool-per-scan map
update and transient maps against the JAX package, on the CPU.

Tolerances: tables, counts, squared distances and meters must be
bit-equal. Log-odds (f32) hold to ``LO_ATOL`` = 4e-6 (about 16 ulp at the
clamp rails): XLA's CPU code fuses ``lo + h*HIT`` into one multiply-add,
the port rounds the product first, so single updates differ by an ulp and
a cell's sequence of scans by a few. The obstacle test is ``log-odds > 0``;
a cell within ``NEAR_ZERO`` of 0 could flip between the two, so the tests
count such cells and require none (a cell that could flip fails the test,
it is not skipped); with none, obstacles, distances and pool tables must
agree exactly.
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
from iris_lama_tpu.nlls import robust as jrobust
from iris_lama_tpu.sdm import mapping as jmap
from iris_lama_tpu.sdm import occupancy as jocc
from iris_lama_tpu.sdm import pool as jpool
from iris_lama_tpu.sdm.geometry import MapGeometry as JGeo
from iris_lama_tpu.utils import simulator as jsim
from iris_lama_tpu.utils.cloud import beam_bucket, pad_scan

from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
from iris_lama_tpu_torch.core import lie as tlie
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.nlls import robust as trobust
from iris_lama_tpu_torch.sdm import mapping as tmap
from iris_lama_tpu_torch.sdm import occupancy as tocc
from iris_lama_tpu_torch.sdm import pool as tpool
from iris_lama_tpu_torch.sdm.geometry import MapGeometry as TGeo
from iris_lama_tpu_torch.utils import state as tstate

LO_ATOL = 4e-6
NEAR_ZERO = 1e-5
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


def T(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _table_equal(tt, jt):
    for f in TABLE:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)


def _keys(rng, n):
    px = rng.integers(16300, 16460, n)
    py = rng.integers(16300, 16460, n)
    return rng.permutation(np.unique((px << 15) | py).astype(np.int32))[:n]


def _log_odds_close(got, want):
    """f32 log-odds within LO_ATOL, and no cell near the obstacle test's
    threshold 0 (such a cell could flip; see the module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=LO_ATOL)
    near = (np.abs(want) <= NEAR_ZERO) & (want != 0)
    assert not near.any(), f"{near.sum()} log-odds within {NEAR_ZERO} of 0"


# ---------------------------------------------------------------------------
# pool: sequential insert, removals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity,n", [(64, 40), (16, 24)])
def test_table_insert_matches_jax(capacity, n):
    """Sequential inserts (with -1 padding, present keys and, at capacity
    16, pool overflow), removals, then re-inserts of removed keys: tables
    and returned slots bit-equal."""
    rng = np.random.default_rng(capacity)
    keys = _keys(rng, n)
    batch = np.concatenate([keys[:n // 2], [-1, -1], keys[n // 2:],
                            keys[:3]]).astype(np.int32)
    jt, js = jpool.table_insert(jpool.table_init(capacity),
                                jnp.asarray(batch))
    tt, ts = tpool.table_insert(tpool.table_init(capacity), T(batch))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _table_equal(tt, jt)
    if capacity == 16:
        assert int(tt.overflow) > 0
    rm = np.concatenate([keys[2:9], [-1]]).astype(np.int32)
    jt, _ = jpool.table_remove(jt, jnp.asarray(rm))
    tt, _ = tpool.table_remove(tt, T(rm))
    again = np.concatenate([keys[4:7], _keys(rng, 6), [-1]]).astype(np.int32)
    jt, js = jpool.table_insert(jt, jnp.asarray(again))
    tt, ts = tpool.table_insert(tt, T(again))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _table_equal(tt, jt)


@pytest.mark.parametrize("fn", ["table_remove", "table_remove_vec"])
def test_table_remove_matches_jax(fn):
    """Present and absent keys and -1 padding; then a re-insert takes the
    freed slots in the free-stack order."""
    rng = np.random.default_rng(3)
    keys = rng.choice(20000, size=40, replace=False).astype(np.int32)
    jt, _ = jpool.table_insert(jpool.table_init(64), jnp.asarray(keys))
    tt, _ = tpool.table_insert(tpool.table_init(64), T(keys))
    rm = np.concatenate([keys[5:20], [99991, 99992],
                         np.full(7, -1)]).astype(np.int32)
    jt, jf = getattr(jpool, fn)(jt, jnp.asarray(rm))
    tt, tf = getattr(tpool, fn)(tt, T(rm))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _table_equal(tt, jt)
    back = np.concatenate([keys[7:12], [-1], keys[30:33]]).astype(np.int32)
    jt, js = jpool.table_insert_unique(jt, jnp.asarray(back))
    tt, ts = tpool.table_insert_unique(tt, T(back))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _table_equal(tt, jt)


def test_table_remove_vec_equals_loop():
    """table_remove_vec is bit-identical to table_remove for unique keys
    (absent keys, -1 padding, free-list push order), in the port."""
    rng = np.random.default_rng(3)
    t = tpool.table_init(64)
    keys = rng.choice(20000, size=40, replace=False).astype(np.int32)
    t, _ = tpool.table_insert(t, T(keys))
    rm = np.concatenate([keys[5:20], np.asarray([99991, 99992], np.int32),
                         np.full(7, -1, np.int32)])
    a, freed_a = tpool.table_remove(t, T(rm))
    b, freed_b = tpool.table_remove_vec(t, T(rm))
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa.numpy(), fb.numpy())
    np.testing.assert_array_equal(freed_a.numpy(), freed_b.numpy())
    looked = tpool.table_lookup(b, T(keys)).numpy()
    assert (looked[5:20] == -1).all()
    assert (looked[:5] >= 0).all() and (looked[20:] >= 0).all()


# ---------------------------------------------------------------------------
# probabilistic occupancy
# ---------------------------------------------------------------------------

def test_probabilistic_constants_equal():
    for name in ("PROB_HIT", "PROB_MISS", "PROB_CLAMP_MIN", "PROB_CLAMP_MAX"):
        assert getattr(tocc, name) == getattr(jocc, name), name


def test_probabilistic_saturate_matches_jax():
    """200 scans of random hit/miss counts from 0 log-odds, each side on
    its own state: within LO_ATOL of the JAX package."""
    rng = np.random.default_rng(7)
    fn = jax.jit(jocc.probabilistic_saturate)
    a = np.zeros(4096, np.float32)
    b = torch.zeros(4096)
    for _ in range(200):
        h = rng.integers(0, 4, 4096)
        m = rng.integers(0, 12, 4096)
        a = np.asarray(fn(jnp.asarray(a), jnp.asarray(h), jnp.asarray(m)))
        b = tocc.probabilistic_saturate(b, T(h), T(m))
        _log_odds_close(b.numpy(), a)


def _seq_per_visit(lo0, hits, misses):
    """Sequential per-visit oracle (probabilistic_occupancy_map.cpp:82-107),
    all hits then all misses."""
    lo = float(lo0)
    for _ in range(int(hits)):
        lo = min(lo + tocc.PROB_HIT, tocc.PROB_CLAMP_MAX)
    for _ in range(int(misses)):
        lo = max(lo + tocc.PROB_MISS, tocc.PROB_CLAMP_MIN)
    return lo


def test_probabilistic_per_visit_clamp_oracle():
    """The closed form equals per-visit sequential clamping, saturated
    cells with mixed evidence over many scans included (the case of
    tests/test_occupancy.py::test_probabilistic_per_visit_clamp_oracle)."""
    r = np.random.default_rng(7)
    lo = np.zeros(64, np.float32)
    for _ in range(40):
        hits = r.integers(0, 8, size=64)
        misses = r.integers(0, 8, size=64)
        got = tocc.probabilistic_saturate(T(lo), T(hits), T(misses)).numpy()
        want = np.array([_seq_per_visit(lo[i], hits[i], misses[i])
                         for i in range(64)], np.float32)
        np.testing.assert_allclose(got, want, atol=1e-5)
        lo = got


def test_probabilistic_saturated_mixed_desaturates():
    """A cell at a clamp rail that gets one hit and one miss leaves the
    rail on both packages (at clamp_max: exactly clamp_max + MISS)."""
    for lo0 in (tocc.PROB_CLAMP_MAX, tocc.PROB_CLAMP_MIN):
        got = tocc.probabilistic_saturate(torch.tensor([lo0]),
                                          torch.tensor([1]),
                                          torch.tensor([1]))
        want = jocc.probabilistic_saturate(jnp.asarray([lo0]),
                                           jnp.asarray([1]),
                                           jnp.asarray([1]))
        _log_odds_close(got.numpy(), want)
        if lo0 == tocc.PROB_CLAMP_MAX:
            np.testing.assert_allclose(
                float(got[0]), tocc.PROB_CLAMP_MAX + tocc.PROB_MISS,
                atol=1e-6)


@pytest.mark.parametrize("kind,param", [("unit", 1.0), ("cauchy", 0.15),
                                        ("tukey", 4.685), ("tstudent", 3.0),
                                        ("huber", 0.5), ("huber", 1.345)])
def test_robust_weights_match_jax(kind, param):
    x = np.random.default_rng(1).normal(0.0, 2.0, 4096).astype(np.float32)
    x[:4] = (0.0, param, -param, 1e-35)
    got = trobust.RobustCost(kind, param).weight(T(x)).numpy()
    want = np.asarray(jrobust.RobustCost(kind, param).weight(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


# ---------------------------------------------------------------------------
# the window update: meters domain and probabilistic model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sim(n_steps, seed, beams, max_range):
    data = jsim.simulate(jsim.SimConfig(
        n_steps=n_steps, seed=seed,
        laser=jsim.LaserSpec(n_beams=beams, max_range=max_range)))
    nb = beam_bucket(beams)
    return data, [pad_scan(c, nb) for c in data.clouds]


def _cfgs(res, log2dim, **kw):
    return (jmap.MappingConfig(geometry=JGeo(res, log2dim, False), **kw),
            tmap.MappingConfig(geometry=TGeo(res, log2dim, False), **kw))


def _se2(xyr):
    return np.array([xyr[0], xyr[1], np.cos(xyr[2]), np.sin(xyr[2])],
                    np.float32)


@pytest.mark.parametrize("occ_model,domain", [
    ("probabilistic", "meters"), ("probabilistic", "squared"),
    ("frequency", "meters")])
def test_scan_window_compute_matches_jax(occ_model, domain):
    """Two real 5 cm scans (720 beams, 10 m, LidarOdometry2D's map: l2_max
    1 m, 1 m rays) into a 640 x 640 window: the second on the first's
    JAX result. Counts, squared distances and meters bit-equal; log-odds
    within LO_ATOL."""
    data, padded = _sim(200, 3, 720, 10.0)
    jc, tc = _cfgs(0.05, 5, l2_max=1.0, truncated_ray=1.0, max_range=10.0,
                   occ_model=occ_model)
    w = jc.window_cells
    geo = jc.geometry
    org = np.asarray(jax.jit(lambda p: jmap.win_mod.window_org(
        geo, geo.w2m(p), jc.window_patches))(
            jnp.asarray(data.poses_gt[0][:2], jnp.float32)))
    occ_dt = np.float32 if occ_model == "probabilistic" else np.uint16
    occ = np.zeros((w, w), occ_dt)
    vis = np.zeros((w, w), np.uint16)
    if domain == "meters":
        dist = np.full((w, w), jc.distance.max_dist, np.float32)
    else:
        dist = np.full((w, w), jc.distance.max_sqdist,
                       np.dtype(jc.sq_dtype))
    jfn = jax.jit(functools.partial(jmap.scan_window_compute, jc))
    for k in (0, 8):
        pose = _se2(data.poses_gt[k])
        p, m, o = padded[k]
        want = jfn(jnp.asarray(pose), p, m, o, jnp.asarray(org),
                   jnp.asarray(occ), jnp.asarray(vis), jnp.asarray(dist))
        to = T(occ) if occ_dt == np.float32 else T(occ.astype(np.int32))
        got = tmap.scan_window_compute(
            tc, T(pose), T(p), T(m), T(o), T(org), to,
            T(vis.astype(np.int32)), T(dist))
        for name in ("vis_new", "occ_add", "vis_add", "d2", "interior",
                     "n_cells", "dist_merged"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(),
                np.asarray(getattr(want, name)).astype(
                    getattr(got, name).numpy().dtype), err_msg=name)
        if occ_model == "probabilistic":
            _log_odds_close(got.occ_new.numpy(), want.occ_new)
        else:
            np.testing.assert_array_equal(got.occ_new.numpy(),
                                          np.asarray(want.occ_new))
        assert int(got.n_cells) > 10000 and (got.d2.numpy() == 0).any()
        occ = np.asarray(want.occ_new).astype(occ_dt)
        vis = np.asarray(want.vis_new).astype(np.uint16)
        dist = np.asarray(want.dist_merged)


# ---------------------------------------------------------------------------
# update_maps (pool per scan) and the transient functions
# ---------------------------------------------------------------------------

def _jmap_state(d):
    return jmap.SlamMapState(
        jpool.PatchTable(*(jnp.asarray(d[f"table_{f}"]) for f in TABLE)),
        jnp.asarray(d["occupied"]), jnp.asarray(d["visited"]),
        jnp.asarray(d["dist"]))


def _jax_np(state):
    d = {f"table_{f}": np.asarray(getattr(state.table, f)) for f in TABLE}
    d.update(occupied=np.asarray(state.occupied),
             visited=np.asarray(state.visited), dist=np.asarray(state.dist))
    return d


def _patch_content(d, max_dist):
    """{patch key: (occ, vis, dist)} of every allocated, non-default patch
    of a state dict (as tests/test_slam2d_e2e.py:_patch_content)."""
    keys, active = jpool.active_keys(jpool.PatchTable(
        *(jnp.asarray(d[f"table_{f}"]) for f in TABLE)))
    keys, active = np.asarray(keys), np.asarray(active)
    out = {}
    for s in np.nonzero(active)[0]:
        blk = (d["occupied"][s], d["visited"][s], d["dist"][s])
        if blk[0].any() or blk[1].any() or (blk[2] != max_dist).any():
            out[int(keys[s])] = blk
    return out


def _contents_match(got, want, max_dist, probabilistic):
    cg, cw = _patch_content(got, max_dist), _patch_content(want, max_dist)
    assert set(cg) == set(cw)
    for key in cw:
        if probabilistic:
            _log_odds_close(cg[key][0], cw[key][0])
        else:
            np.testing.assert_array_equal(cg[key][0], cw[key][0])
        np.testing.assert_array_equal(cg[key][1], cw[key][1])
        np.testing.assert_array_equal(cg[key][2], cw[key][2])
    return len(cw)


@pytest.mark.parametrize("occ_model", ["frequency", "probabilistic"])
@pytest.mark.parametrize("transient", [False, True])
def test_update_maps_teacher_forced(occ_model, transient):
    """10 scans along the ground-truth poses (0.1 m cells, 16-cell patches,
    6 m beams; LidarOdometry2D's 1 m rays for the probabilistic model),
    the port from the JAX state before each scan: tables bit-equal after
    each scan, every patch's content keyed by patch."""
    data, padded = _sim(120, 13, 120, 6.0)
    kw = dict(max_range=6.0, capacity=512, occ_model=occ_model,
              transient=transient, transient_expand=1.0, max_removals=40)
    if occ_model == "probabilistic":
        kw.update(l2_max=1.0, truncated_ray=1.0)
    jc, tc = _cfgs(0.1, 4, **kw)
    max_dist = np.float32(jc.distance.max_dist)
    jstate = jmap.slam_map_init(jc)
    jfn = jax.jit(functools.partial(jmap.update_maps, cfg=jc))
    pruned = 0

    def active(d):
        keys, act = jpool.active_keys(jpool.PatchTable(
            *(jnp.asarray(d[f"table_{f}"]) for f in TABLE)))
        return set(np.asarray(keys)[np.asarray(act)].tolist())

    for k in range(0, 120, 12):
        pose = _se2(data.poses_gt[k])
        p, m, o = padded[k]
        before = _jax_np(jstate)
        jstate, jinfo = jfn(jstate, pose=jnp.asarray(pose), points=p,
                            mask=m, origin=o)
        want = _jax_np(jstate)
        tstate_, tinfo = tmap.update_maps(tstate.map_from_numpy(before,
                                                                "cpu"),
                                          tc, T(pose), T(p), T(m), T(o))
        got = tstate.map_to_numpy(tstate_)
        for f in TABLE:
            np.testing.assert_array_equal(got[f"table_{f}"],
                                          want[f"table_{f}"], err_msg=f)
        for key in ("processed_cells", "num_patches", "overflow"):
            assert int(tinfo[key]) == int(jinfo[key]), key
        n = _contents_match(got, want, max_dist,
                            occ_model == "probabilistic")
        assert n > 0
        pruned += len(active(before) - active(want))
    assert int(jinfo["overflow"]) == 0
    assert (pruned > 0) == transient    # patches left the pool


def _pool_with_patches(cfg, n, seed):
    """A JAX map state with ``n`` patches around the origin, random
    content."""
    rng = np.random.default_rng(seed)
    st = jmap.slam_map_init(cfg)
    c = cfg.geometry.cell_offset >> cfg.geometry.log2dim
    px = c + rng.permutation(np.arange(-20, 20))
    py = c + rng.permutation(np.arange(-20, 20))
    keys = np.unique((px[:, None] << 15 | py[None, :]).reshape(-1))
    keys = rng.permutation(keys)[:n].astype(np.int32)
    table, _ = jpool.table_insert_unique(st.table, jnp.asarray(keys))
    shape = st.dist.shape
    occ = (rng.normal(0, 1, shape).astype(np.float32)
           if st.occupied.dtype == jnp.float32
           else rng.integers(0, 9, shape).astype(np.uint16))
    return jmap.SlamMapState(
        table, jnp.asarray(occ),
        jnp.asarray(rng.integers(0, 9, shape).astype(np.uint16)),
        jnp.asarray(rng.uniform(0, 1, shape).astype(np.float32)))


@pytest.mark.parametrize("occ_model", ["frequency", "probabilistic"])
def test_prune_transient_pool_beyond_budget(occ_model):
    """422 candidates against a budget of 160: the lowest 160 slots
    go first, the rest on the next calls; tables and cell arrays
    bit-equal after each call."""
    jc, tc = _cfgs(0.1, 4, capacity=1200, max_removals=160,
                   occ_model=occ_model)
    js = _pool_with_patches(jc, 1000, 4)
    d = _jax_np(js)
    ts = tstate.map_from_numpy(d, "cpu")
    center = np.array([3.0, -2.0], np.float32)
    half = np.array([26.0, 21.0], np.float32)
    jfn = jax.jit(functools.partial(jmap.prune_transient_pool, cfg=jc))
    removed = []
    for _ in range(4):
        n0 = int(js.table.n_free)
        js = jfn(js, a_center=jnp.asarray(center), a_half=jnp.asarray(half))
        ts = tmap.prune_transient_pool(ts, tc, T(center), T(half))
        want, got = _jax_np(js), tstate.map_to_numpy(ts)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        removed.append(int(js.table.n_free) - n0)
    assert removed[0] == 160 and removed[1] == 160
    assert removed[2:] == [102, 0]


@pytest.mark.parametrize("dist_dtype", ["int8", "float32"])
def test_resident_transient_reset_matches_jax(dist_dtype):
    jc, tc = _cfgs(0.1, 4, max_range=6.0)
    rng = np.random.default_rng(9)
    w = jc.resident_window_cells
    org = np.array([jc.geometry.cell_offset - w // 2 + 32,
                    jc.geometry.cell_offset - w // 2 - 16], np.int32)
    occ = rng.normal(0, 1, (w, w)).astype(np.float32)
    vis = rng.integers(0, 9, (w, w)).astype(np.int32)
    dist = (rng.integers(0, 26, (w, w)).astype(np.int8)
            if dist_dtype == "int8"
            else rng.uniform(0, 1, (w, w)).astype(np.float32))
    center = np.array([0.7, -1.1], np.float32)
    half = np.array([4.0, 2.5], np.float32)
    want = jax.jit(functools.partial(jmap.resident_transient_reset, jc))(
        jnp.asarray(org), jnp.asarray(occ), jnp.asarray(vis),
        jnp.asarray(dist), jnp.asarray(center), jnp.asarray(half))
    got = tmap.resident_transient_reset(tc, T(org), T(occ), T(vis), T(dist),
                                        T(center), T(half))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    kept = (got[1].numpy() == vis)
    assert 0.05 < kept.mean() < 0.95


# ---------------------------------------------------------------------------
# Slam2D: transient map and the pool-per-scan path
# ---------------------------------------------------------------------------

SLAM_OPTS = dict(resolution=0.1, patch_size=16, max_range=8.0,
                 trans_thresh=0.2, rot_thresh=0.2, capacity=1024)


def _port_run(n_steps, seed, **kw):
    data, padded = _sim(n_steps, seed, 120, 8.0)
    slam = Slam2D(Slam2DOptions(**SLAM_OPTS, **kw), device="cpu")
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    staged = [tuple(torch.as_tensor(a) for a in p) for p in padded]
    acc = slam.update_many_prepadded(staged, data.odometry)
    return acc, slam


def _port_content(slam):
    return tstate.map_to_numpy(slam.map)


@pytest.mark.parametrize("kw", [
    dict(transient_map=True), dict(resident_window=False),
    dict(resident_window=False, transient_map=True)],
    ids=["transient", "pool", "pool_transient"])
def test_slam2d_options_match_jax(kw):
    """40 steps on both packages: accepted scans, trajectories within 1e-4
    m / rad, and the flushed pools (tables and cell arrays) bit-equal."""
    data, padded = _sim(40, 6, 120, 8.0)
    j = JSlam2D(JOptions(**SLAM_OPTS, **kw))
    j.set_prior(JPose2D(*data.poses_gt[0]))
    jacc = j.update_many_prepadded(
        [tuple(jnp.asarray(a) for a in p) for p in padded], data.odometry)
    acc, slam = _port_run(40, 6, **kw)
    assert acc == jacc
    a, b = slam.trajectory(), j.trajectory()
    assert np.abs(a[:, :2] - b[:, :2]).max() <= 1e-4
    assert np.abs(np.angle(np.exp(1j * (a[:, 2] - b[:, 2])))).max() <= 1e-4
    got, want = _port_content(slam), _jax_np(j.map)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert slam.escaped_count() == 0
    if kw.get("transient_map"):
        assert int(j.map.table.num_patches()) < 100


def test_resident_matches_pool_path():
    """Port of tests/test_slam2d_e2e.py::test_resident_matches_pool_path:
    the resident step and the pool path give identical trajectories and
    identical map content, keyed by patch."""
    _, slam_r = _port_run(80, 1, resident_window=True,
                          resident_extra_patches=1)
    _, slam_p = _port_run(80, 1, resident_window=False)
    np.testing.assert_array_equal(slam_r.trajectory(), slam_p.trajectory())
    max_dist = np.float32(slam_r.cfg.distance.max_dist)
    _contents_match(_port_content(slam_r), _port_content(slam_p), max_dist,
                    False)
    assert slam_r.n_reorgs >= 1


def test_resident_transient_matches_pool_path():
    """Port of tests/test_slam2d_e2e.py::
    test_resident_transient_matches_pool_path: transient maps on the
    resident window (patch resets + per-scan pool prunes) equal the pool
    path, and the run prunes."""
    _, slam_r = _port_run(120, 3, resident_window=True,
                          resident_extra_patches=1, transient_map=True)
    _, slam_p = _port_run(120, 3, resident_window=False, transient_map=True)
    np.testing.assert_array_equal(slam_r.trajectory(), slam_p.trajectory())
    max_dist = np.float32(slam_r.cfg.distance.max_dist)
    n = _contents_match(_port_content(slam_r), _port_content(slam_p),
                        max_dist, False)
    assert n < 700, n
    assert slam_r.n_reorgs >= 1 and slam_r.n_scrolls == 0


def test_transient_scan_keeps_pool_bounded():
    """A transient run's pool stays small while a plain run's grows."""
    _, a = _port_run(120, 3, resident_window=False, transient_map=True)
    _, b = _port_run(120, 3, resident_window=False)
    na, nb = int(a.map.table.num_patches()), int(b.map.table.num_patches())
    assert na < nb // 2, (na, nb)
    assert int(a.map.table.overflow) == 0


def test_transient_pose_helpers_use_the_scan_box():
    """transient_keep_aabb: the symmetric box of the valid endpoints, x
    transient_expand, grown by twice the distance range."""
    _, tc = _cfgs(0.1, 4, l2_max=0.5, transient_expand=2.0)
    pose = tlie.se2(1.0, 2.0, 0.0)
    pts = torch.tensor([[3.0, 0.5, 0.0], [-1.0, -0.25, 0.0],
                        [50.0, 50.0, 0.0]])
    mask = torch.tensor([True, True, False])
    g = tmap.beam_geometry(tc, pose, pts, mask, torch.zeros(3))
    c, h = tmap.transient_keep_aabb(tc, pose, g)
    np.testing.assert_allclose(c.numpy(), [1.0, 2.0])
    np.testing.assert_allclose(h.numpy(), [3.0 * 2 + 1.0, 0.5 * 2 + 1.0],
                               rtol=1e-6)
