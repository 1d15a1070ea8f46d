"""The port's TSDF and marching cubes (iris_lama_tpu_torch/sdm/tsdf.py,
sdm/marching_cubes.py) against the JAX package's, on the CPU.

The six cases of tests/test_tsdf.py run on the port, each state also held
against the JAX package's for the same calls: tables and the observed set
(``weight > 0``) equal, distances and weights within rtol 1e-5 (float sums
in another order), trilinear reads within 1e-5, meshes equal. Then the
KeySet dedup: repeated hit cells, a forced hash collision between two
distinct cells (both packages drop the second point), and the 4,096 cap on
the unique patch keys of a cloud (the masked cells' key -1 among them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.sdm import marching_cubes as jmc
from iris_lama_tpu.sdm import tsdf as jtsdf

from iris_lama_tpu_torch.sdm import marching_cubes as mc
from iris_lama_tpu_torch.sdm.occupancy3d import locate3
from iris_lama_tpu_torch.sdm import tsdf as tsdf_mod

TABLE = ("keys", "slots", "free_slots", "n_free", "overflow")
RTOL = 1e-5

# the JAX insert runs eagerly, as its tests run it: under jit XLA fuses
# ``hits + dirn * truncate`` into an FMA, and ray ends on a cell boundary
# (the wall grids below) round to the other cell
_jinsert = jtsdf.insert_point_cloud


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcfg_of(cfg):
    return jtsdf.TSDFConfig(**{f: getattr(cfg, f) for f in (
        "resolution", "log2dim", "truncate_size", "maximum_weight",
        "capacity", "max_beams")})


# one configuration and one padded cloud size for the JAX package's
# tests' cases: its eager ops compile once per shape (~8 s an insert)
CFG = tsdf_mod.TSDFConfig(resolution=0.05, capacity=4096, max_beams=256)
PAD_B = 1088


class Pair:
    """Port and JAX TSDF states fed the same clouds, compared after each.
    Clouds are padded to ``pad`` points with masked copies of their first
    point (last in index order, so they shadow no point's hash)."""

    def __init__(self, cfg=CFG, pad=PAD_B):
        self.cfg, self.jcfg, self.pad = cfg, jcfg_of(cfg), pad
        self.s = tsdf_mod.tsdf_init(cfg, device="cpu")
        self.j = jtsdf.tsdf_init(self.jcfg)

    def insert(self, pts, origin, mask=None):
        pts = np.asarray(pts, np.float32)
        origin = np.asarray(origin, np.float32)
        mask = np.ones(len(pts), bool) if mask is None else mask
        if self.pad:
            extra = self.pad - len(pts)
            pts = np.concatenate([pts, np.repeat(pts[:1], extra, 0)])
            mask = np.concatenate([mask, np.zeros(extra, bool)])
        self.s, n = tsdf_mod.insert_point_cloud(
            self.s, self.cfg, torch.as_tensor(pts), torch.as_tensor(mask),
            torch.as_tensor(origin))
        self.j, jn = _jinsert(self.j, self.jcfg, jnp.asarray(pts),
                              jnp.asarray(mask), jnp.asarray(origin))
        assert int(n) == int(jn)
        self.check()
        return int(n)

    def check(self):
        for f in TABLE:
            np.testing.assert_array_equal(
                getattr(self.s.table, f).numpy(),
                np.asarray(getattr(self.j.table, f)), f)
        w, jw = self.s.weight.numpy(), np.asarray(self.j.weight)
        np.testing.assert_array_equal(w > 0, jw > 0)
        np.testing.assert_allclose(w, jw, rtol=RTOL, atol=0)
        np.testing.assert_allclose(self.s.dist.numpy(),
                                   np.asarray(self.j.dist), rtol=RTOL,
                                   atol=1e-7)


def _walk(start, end, steps):
    """The cells strictly between ``start`` and ``end`` of the reference's
    integer ray walk (map.cpp:198-258), at most ``steps`` of them."""
    d = end - start
    n = int(np.abs(d).max())
    t = np.arange(1, min(n - 1, steps) + 1)[:, None]
    return start + np.sign(d) * ((2 * t * np.abs(d) + n) // (2 * max(n, 1)))


def reference_integrate(cfg, clouds):
    """The JAX test's sequential numpy oracle of insertPointCloud."""
    cells = {}
    for origin, pts in clouds:
        seen = set()
        for hit in pts:
            hc = tuple(np.floor(hit * cfg.scale + 0.5).astype(int)
                       + cfg.cell_offset)
            if hc in seen:
                continue
            seen.add(hc)
            dvec = hit - origin
            sqn = float(dvec @ dvec)
            dirn = dvec / np.sqrt(sqn)
            trunc = min(sqn, cfg.truncate_size)
            start = np.floor((hit - dirn * trunc) * cfg.scale + 0.5
                             ).astype(int) + cfg.cell_offset
            end = np.floor((hit + dirn * cfg.truncate_size) * cfg.scale
                           + 0.5).astype(int) + cfg.cell_offset
            ray = _walk(start, end, cfg.ray_steps)
            inv_dle = 1.0 / (cfg.delta - cfg.epsilon)
            for c in ray:
                vch = hit - (c - cfg.cell_offset) * cfg.resolution
                d = np.linalg.norm(vch) * np.sign(vch @ dvec)
                if d < -cfg.delta:
                    continue
                w = ((d + cfg.delta) / sqn * inv_dle if d <= -cfg.epsilon
                     else 1.0 / sqn)
                cell = cells.setdefault(tuple(c), [cfg.truncate_size, 0.0])
                cell[0] = (cell[1] * cell[0] + w * d) / (cell[1] + w)
                cell[1] = min(cell[1] + w, cfg.maximum_weight)
    return cells


def make_cloud(rng, n=40):
    """Random points on a wall at x = 2."""
    return np.stack([np.full(n, 2.0), rng.uniform(-1, 1, n),
                     rng.uniform(-0.3, 0.3, n)], -1).astype(np.float32)


def _oracle_cells(p, oracle):
    ocells = torch.as_tensor(np.asarray(sorted(oracle), np.int32))
    slots, idx = locate3(p.s.table, p.cfg, ocells, p.s.dist.shape[0] - 1)
    assert (slots >= 0).all()
    exp = np.array([oracle[tuple(c)] for c in ocells.tolist()])
    return p.s.dist[idx].numpy(), p.s.weight[idx].numpy(), exp


def test_integration_matches_sequential_oracle():
    rng = np.random.default_rng(21)
    cfg = CFG
    p = Pair()
    origin = np.zeros(3, np.float32)
    pts = make_cloud(rng, 40)
    p.insert(pts, origin)
    got_d, got_w, exp = _oracle_cells(
        p, reference_integrate(cfg, [(origin, pts)]))
    np.testing.assert_allclose(got_d, exp[:, 0], atol=2e-3)
    np.testing.assert_allclose(got_w, exp[:, 1], rtol=1e-3, atol=1e-6)


def test_multiple_scans_accumulate():
    rng = np.random.default_rng(22)
    cfg = CFG
    p = Pair()
    origin = np.zeros(3, np.float32)
    clouds = [make_cloud(rng, 30) for _ in range(3)]
    for pts in clouds:
        p.insert(pts, origin)
    got_d, _, exp = _oracle_cells(
        p, reference_integrate(cfg, [(origin, c) for c in clouds]))
    np.testing.assert_allclose(got_d, exp[:, 0], atol=5e-3)


def _wall_grid(step, ny, nz):
    ys, zs = np.meshgrid(np.arange(-ny, ny + 1) * step,
                         np.arange(-nz, nz + 1) * step)
    return np.stack([np.full(ys.size, 2.0), ys.ravel(), zs.ravel()],
                    -1).astype(np.float32)


def test_interp_surface_zero_crossing():
    cfg = CFG
    p = Pair()
    p.insert(_wall_grid(0.05, 10, 4), np.zeros(3))
    q = np.array([[1.93, 0.0, 0.0], [2.07, 0.0, 0.0]], np.float32)
    d, g = tsdf_mod.distance_interp(p.s, cfg, torch.as_tensor(q))
    jd, jg = jtsdf.distance_interp(p.j, p.jcfg, jnp.asarray(q))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5, rtol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=0)
    assert float(d[0]) > 0.02        # positive in front of the wall
    assert float(d[1]) < -0.02       # negative behind it
    # random reads around the wall
    rng = np.random.default_rng(4)
    q = np.stack([rng.uniform(1.7, 2.3, 400), rng.uniform(-0.6, 0.6, 400),
                  rng.uniform(-0.3, 0.3, 400)], -1).astype(np.float32)
    d, g = tsdf_mod.distance_interp(p.s, cfg, torch.as_tensor(q))
    jd, jg = jtsdf.distance_interp(p.j, p.jcfg, jnp.asarray(q))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5, rtol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=0)


def test_marching_cubes_sphere():
    n, res = 24, 0.1
    coords = (np.arange(n) - n / 2) * res
    zz, yy, xx = np.meshgrid(coords, coords, coords, indexing="ij")
    sdf = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2) - 1.0
    mask = np.ones_like(sdf, bool)
    origin = np.array([coords[0]] * 3)
    verts, tris = mc.marching_cubes_dense(sdf, mask, origin, res)
    jverts, jtris = jmc.marching_cubes_dense(sdf, mask, origin, res)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(tris, jtris)
    assert len(verts) > 100
    np.testing.assert_allclose(np.linalg.norm(verts, axis=1), 1.0, atol=res)
    assert tris.max() < len(verts)


def test_tri_table_sanity():
    np.testing.assert_array_equal(mc.TRI_TABLE, jmc.TRI_TABLE)
    assert (mc.TRI_TABLE[0] == -1).all()
    assert (mc.TRI_TABLE[255] == -1).all()
    for c in range(8):
        assert (mc.TRI_TABLE[1 << c] >= 0).sum() == 3, c


def test_tsdf_mesh_from_wall():
    cfg = CFG
    p = Pair()
    ys, zs = np.meshgrid(np.linspace(-0.5, 0.5, 41),
                         np.linspace(-0.3, 0.3, 25))
    pts = np.stack([np.full(ys.size, 2.0), ys.ravel(), zs.ravel()], -1)
    p.insert(pts, np.zeros(3))
    verts, tris = tsdf_mod.to_mesh(p.s, cfg)
    jverts, jtris = jtsdf.to_mesh(p.j, p.jcfg)
    assert len(verts) > 20
    assert abs(np.median(verts[:, 0]) - 2.0) < 0.1
    np.testing.assert_array_equal(tris, jtris)
    np.testing.assert_allclose(verts, jverts, atol=1e-6)
    empty = tsdf_mod.tsdf_init(cfg, device="cpu")
    assert tsdf_mod.to_mesh(empty, cfg)[1].shape == (0, 3)


# ---------------------------------------------------------------------------
# The KeySet dedup and the unique-key cap
# ---------------------------------------------------------------------------

# two distinct cells whose KeySet hashes are equal (a birthday search over
# cells within 75 m of the origin at 5 cm, 16-cell patches)
COLLIDE = (np.array([8027, 7706, 8734]), np.array([7372, 7085, 8300]))


def test_hash_dedup_repeats_and_collision():
    cfg = CFG
    a, b = COLLIDE
    ha, hb = (int(tsdf_mod.cell_hash(torch.as_tensor(c, dtype=torch.int32)))
              for c in COLLIDE)
    assert ha == hb and not np.array_equal(a, b)
    wa = (a - cfg.cell_offset) * cfg.resolution
    wb = (b - cfg.cell_offset) * cfg.resolution
    rng = np.random.default_rng(23)
    wall = make_cloud(rng, 20)
    # repeated hit cells (the first point of each cell integrates), then
    # the colliding pair: the second is dropped though its cell differs
    pts = np.concatenate([wall, wall[:7] + 0.004, [wa, wb]]).astype(
        np.float32)
    p = Pair()
    n = p.insert(pts, np.zeros(3))
    assert n == 21
    keep = tsdf_mod.first_of_hash(tsdf_mod.cell_hash(cfg.w2m(
        torch.as_tensor(pts))))
    assert bool(keep[-2]) and not bool(keep[-1])
    # the other order keeps the other cell; a masked point still claims
    # its hash (as in the JAX package), so its twin is dropped too
    rev = pts[::-1].copy()
    keep = tsdf_mod.first_of_hash(tsdf_mod.cell_hash(cfg.w2m(
        torch.as_tensor(rev))))
    assert bool(keep[0]) and not bool(keep[1]) and int(keep.sum()) == 21
    mask = torch.ones(len(pts), dtype=torch.bool)
    mask[-2] = False
    state, n = tsdf_mod.insert_point_cloud(
        tsdf_mod.tsdf_init(cfg, device="cpu"), cfg, torch.as_tensor(pts),
        mask, torch.zeros(3))
    assert int(n) == 20


def test_unique_key_cap_4096():
    """A cloud whose rays touch more than 4,096 patch keys (2-cell
    patches; masked cells add the key -1): both packages allocate the
    same 4,096 smallest keys and drop the rest's updates."""
    cfg = tsdf_mod.TSDFConfig(resolution=0.05, log2dim=1, capacity=8192,
                              max_beams=2048)
    rng = np.random.default_rng(24)
    n = 2000
    pts = np.stack([rng.uniform(1, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(-1, 1, n)], -1).astype(np.float32)
    mask = rng.random(n) < 0.9
    p = Pair(cfg, pad=None)
    p.insert(pts, np.zeros(3), mask)
    # the cap, not the pool (capacity 8,192), bounds the allocation: 4,096
    # unique keys, the masked cells' -1 among them
    assert int(p.s.table.num_patches()) == 4095
    assert int(p.s.table.overflow) == 0
