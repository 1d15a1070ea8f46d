"""The port's 3D dynamic distance map (iris_lama_tpu_torch/sdm/
distance3d.py) against the JAX package's, on the CPU.

The six cases of tests/test_distance3d.py run on the port, each state
also held against the JAX package's for the same calls: tables,
obstacles, ``sqdist`` and dirty bits bit-exact, trilinear distances and
gradients within 1e-5. Then ``update3``'s chunked recompute and its
capped drain: the same slots drained in the same (ascending) order as
JAX's ``nonzero(size=max_dirty)``, the overflow keeping its dirty bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.sdm import distance3d as jd3
from iris_lama_tpu.sdm import occupancy3d as jo3

from iris_lama_tpu_torch.sdm import distance3d as d3
from iris_lama_tpu_torch.sdm import occupancy3d as o3
from iris_lama_tpu_torch.sdm import pool as pool_mod

CFG = d3.Distance3Config(o3.MapGeometry3(resolution=0.1, log2dim=3),
                         l2_max=0.4)
JCFG = jd3.Distance3Config(jo3.MapGeometry3(resolution=0.1, log2dim=3),
                           l2_max=0.4)
TABLE = ("keys", "slots", "free_slots", "n_free", "overflow")
INTERP_ATOL = 1e-5

# the JAX functions jitted once per configuration (eager JAX re-traces
# every call: ~1 s an update3 on the CPU)
_jadd = jax.jit(jd3.add_obstacles3, static_argnums=(1,))
_jremove = jax.jit(jd3.remove_obstacles3, static_argnums=(1,))
_jupdate = jax.jit(jd3.update3, static_argnums=(1, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(pts):
    return CFG.geometry.w2m(torch.as_tensor(np.array(pts, np.float32)))


def _jcells(pts):
    return JCFG.geometry.w2m(jnp.asarray(np.array(pts, np.float32)))


class Pair:
    """A port state and a JAX state driven by the same calls, compared
    after each."""

    def __init__(self, capacity=256, cfg=CFG, jcfg=JCFG):
        self.cfg, self.jcfg = cfg, jcfg
        self.s = d3.distance3_init(cfg, capacity, device="cpu")
        self.j = jd3.distance3_init(jcfg, capacity)

    def add(self, pts):
        self.s = d3.add_obstacles3(self.s, self.cfg, _cells(pts))
        self.j = _jadd(self.j, self.jcfg, _jcells(pts))
        return self.check()

    def remove(self, pts):
        self.s = d3.remove_obstacles3(self.s, self.cfg, _cells(pts))
        self.j = _jremove(self.j, self.jcfg, _jcells(pts))
        return self.check()

    def update(self, max_dirty=None):
        self.s = d3.update3(self.s, self.cfg, max_dirty)
        self.j = _jupdate(self.j, self.jcfg, max_dirty)
        return self.check()

    def check(self):
        for f in TABLE:
            np.testing.assert_array_equal(
                getattr(self.s.table, f).numpy(),
                np.asarray(getattr(self.j.table, f)), f)
        for f in ("obstacle", "sqdist", "dirty"):
            np.testing.assert_array_equal(getattr(self.s, f).numpy(),
                                          np.asarray(getattr(self.j, f)), f)
        return self

    def n_dirty(self):
        return int(d3.dirty_slots(self.s).numel())


def _obstacle_cells(state):
    keys = pool_mod.active_keys(state.table)[0].numpy()
    mask = pool_mod.active_slot_mask(state.table).numpy()
    obst = state.obstacle.numpy()
    out = []
    length = CFG.geometry.patch_length
    m = (1 << 10) - 1
    for slot in np.nonzero(mask)[0]:
        k = int(keys[slot])
        pxyz = np.array([k >> 20, (k >> 10) & m, k & m]) * length
        for z, y, x in zip(*np.nonzero(obst[slot])):
            out.append(pxyz + np.array([x, y, z]))
    return np.asarray(out) if out else np.zeros((0, 3), np.int64)


def _check_exact(state):
    """Every allocated cell's sqdist equals the brute-force capped value
    (the JAX test's oracle)."""
    obs = _obstacle_cells(state)
    keys = pool_mod.active_keys(state.table)[0].numpy()
    mask = pool_mod.active_slot_mask(state.table).numpy()
    sq = state.sqdist.numpy()
    length = CFG.geometry.patch_length
    m = (1 << 10) - 1
    zz, yy, xx = np.mgrid[0:length, 0:length, 0:length]
    for slot in np.nonzero(mask)[0]:
        k = int(keys[slot])
        anchor = np.array([k >> 20, (k >> 10) & m, k & m]) * length
        cells = anchor + np.stack([xx, yy, zz], -1)
        if len(obs):
            d2 = ((cells[..., None, :] - obs[None, None, None]) ** 2
                  ).sum(-1).min(-1)
        else:
            d2 = np.full((length,) * 3, CFG.max_sqdist)
        np.testing.assert_array_equal(sq[slot],
                                      np.minimum(d2, CFG.max_sqdist))


def test_add_obstacles_matches_brute_force():
    p = Pair().add([[0.15, 0.22, 0.31], [0.55, 0.18, 0.40],
                    [-0.42, -0.13, 0.08]]).update()
    _check_exact(p.s)


def test_incremental_equals_batch():
    a = [[0.1, 0.1, 0.1], [0.4, 0.2, 0.3]]
    b = [[-0.3, 0.15, -0.2], [0.12, 0.42, 0.11]]
    inc = Pair().add(a).update().add(b).update()
    bat = Pair().add(a + b).update()
    _check_exact(inc.s)
    _check_exact(bat.s)


def test_remove_obstacles_raise_equivalent():
    a = [[0.1, 0.1, 0.1], [0.3, 0.1, 0.1]]
    b = [[0.1, 0.35, 0.1]]
    p = Pair().add(a + b).update().remove(b).update()
    _check_exact(p.s)
    assert len(_obstacle_cells(p.s)) == len(a)


def test_capped_max_dirty_with_overflow_carry():
    p = Pair().add([[0.15, 0.22, 0.31], [0.55, 0.18, 0.40],
                    [-0.42, -0.13, 0.08], [0.8, -0.6, 0.2]])
    n_dirty = p.n_dirty()
    assert n_dirty > 3
    before = d3.dirty_slots(p.s)
    p.update(max_dirty=3)
    # the three smallest dirty slots were drained, the rest stay dirty
    np.testing.assert_array_equal(d3.dirty_slots(p.s).numpy(),
                                  before[3:].numpy())
    rem = p.n_dirty()
    assert rem == n_dirty - 3
    while rem > 0:
        rem = p.update(max_dirty=3).n_dirty()
    _check_exact(p.s)


def test_capped_max_dirty_incremental_remove():
    a = [[0.1, 0.1, 0.1], [0.3, 0.1, 0.1]]
    b = [[0.1, 0.35, 0.1]]
    p = Pair().add(a + b)
    for _ in range(64):
        if not p.update(max_dirty=4).n_dirty():
            break
    p.remove(b)
    for _ in range(64):
        if not p.update(max_dirty=4).n_dirty():
            break
    _check_exact(p.s)


def test_trilinear_interp_and_gradient():
    p = Pair().add([[0.2, 0.2, 0.2]]).update()
    q = np.array([[0.333, 0.217, 0.243], [0.183, 0.274, 0.157]], np.float32)
    tq = torch.as_tensor(q)
    d, g = d3.distance3(p.s, CFG, tq)
    jd, jg = jd3.distance3(p.j, JCFG, jnp.asarray(q))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=INTERP_ATOL,
                               rtol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=INTERP_ATOL,
                               rtol=0)
    ref = np.linalg.norm(q - np.array([0.2, 0.2, 0.2]), axis=1)
    assert np.all(np.abs(d.numpy() - ref) < 2.5 * CFG.geometry.resolution)
    eps = 1e-3
    for ax in range(3):
        dq = torch.zeros(3)
        dq[ax] = eps
        dp, _ = d3.distance3(p.s, CFG, tq + dq)
        dm, _ = d3.distance3(p.s, CFG, tq - dq)
        fd = (dp - dm).numpy() / (2 * eps)
        np.testing.assert_allclose(g[:, ax].numpy(), fd, atol=2e-2)
    far = torch.tensor([[3.0, 3.0, 3.0]])
    dfar, gfar = d3.distance3(p.s, CFG, far)
    assert abs(float(dfar[0]) - CFG.max_dist) < 1e-6
    np.testing.assert_allclose(gfar.numpy(), 0.0, atol=1e-6)


def test_random_queries_match_jax():
    """Trilinear reads at random points around random obstacles, within
    1e-5 of the JAX package's (distances and gradients)."""
    rng = np.random.default_rng(5)
    p = Pair().add(rng.uniform(-0.6, 0.6, (12, 3))).update()
    q = rng.uniform(-0.9, 0.9, (500, 3)).astype(np.float32)
    d, g = d3.distance3(p.s, CFG, torch.as_tensor(q))
    jd, jg = jd3.distance3(p.j, JCFG, jnp.asarray(q))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=INTERP_ATOL,
                               rtol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=INTERP_ATOL,
                               rtol=0)


def test_update3_chunks_and_order(monkeypatch):
    """A recompute split into chunks of one window gives the states of one
    batch; a capped drain with many chunks drains JAX's slots."""
    rng = np.random.default_rng(9)
    pts = rng.uniform(-0.8, 0.8, (6, 3))
    whole = Pair().add(pts).update()
    monkeypatch.setattr(d3, "UPDATE_CHUNK_CELLS", 1)
    chunked = Pair().add(pts)
    assert chunked.n_dirty() > 20
    chunked.update(max_dirty=17).update(max_dirty=5).update()
    for f in ("obstacle", "sqdist", "dirty"):
        assert torch.equal(getattr(whole.s, f), getattr(chunked.s, f)), f
    _check_exact(chunked.s)
