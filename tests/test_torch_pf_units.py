"""The port's particle-filter pieces against the JAX package, on the CPU.

* B6 (``ops/gn_batch.py``): the plain PyTorch version against the JAX
  batched whole-solve kernel in Pallas interpret mode (vmapped over the
  particles) and against the JAX single-particle kernel B4 (``gn_solve``).
  Tolerances: state rtol 1e-4 / atol 1e-5, chi2 and the likelihood SSE
  rtol 1e-4, iterations equal. The ten sums are reduced in another order
  (torch's vectorised sum against the interpreter's), so they agree to a
  few ulp; a stop test within an ulp could move an iteration count, which
  is then reported by the failing assertion.
* Batched B1 and B3: plain versions on a particle axis against the vmapped
  JAX deposit (the batch rule of ``scatter_counts_2d``, Pallas interpret
  and XLA) and the vmapped ``distance.edt2d``; bit-exact.
* PF device functions: motion noise, normalise / Neff / systematic
  resampling, the sub-window slice and the batched map update, on the same
  inputs and random draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos import pf_slam2d as jpf
from iris_lama_tpu.ops import gn_batch as jgb
from iris_lama_tpu.ops import gn_solve as jgs
from iris_lama_tpu.ops import scatter_matmul as jsm
from iris_lama_tpu.sdm import distance as jdist
from iris_lama_tpu.sdm import mapping as jmap
from iris_lama_tpu.sdm.geometry import MapGeometry as JGeometry
from iris_lama_tpu.utils import simulator as jsim
from iris_lama_tpu.utils.cloud import pad_scan

from iris_lama_tpu_torch.algos import pf_slam2d as tpf
from iris_lama_tpu_torch.ops import edt_pallas as tedt
from iris_lama_tpu_torch.ops import gn_batch as tgb
from iris_lama_tpu_torch.ops import scatter_matmul as tsm
from iris_lama_tpu_torch.sdm import mapping as tmap

# the world of tests/test_gn_batch.py: 0.1 m cells, 96 x 96, cap 25
RES, H, W, MAXD, CAUCHY = 0.1, 96, 96, 0.5, 0.15
GEO = JGeometry(RES, 4, False)
ORG = np.array([GEO.cell_offset] * 2, np.int32)
KW = dict(max_dist=MAXD, res=RES, scale=GEO.scale,
          cell_offset=GEO.cell_offset, cauchy_c=CAUCHY, eps1=1e-4, eps2=1e-4)


def _world(rng, b):
    obst = np.zeros((H, W), bool)
    obst[20, 10:80] = True
    obst[20:80, 75] = True
    extra = rng.integers(15, 80, (10, 2))
    obst[extra[:, 0], extra[:, 1]] = True
    ys, xs = np.nonzero(obst)
    yy, xx = np.mgrid[0:H, 0:W]
    d2 = ((yy[..., None] - ys) ** 2 + (xx[..., None] - xs) ** 2).min(-1)
    grid = np.minimum(d2, 25).astype(np.int8)
    k = rng.integers(0, len(ys), b)
    pts = np.stack([(xs[k] + 0.5) * 0.1, (ys[k] + 0.5) * 0.1],
                   -1).astype(np.float32)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    mask = rng.uniform(size=b) < 0.9
    return grid, pts, mask


def _states(*xyr):
    return np.array([[x, y, np.cos(r), np.sin(r)] for x, y, r in xyr],
                    np.float32)


STATES3 = ((0.25, -0.15, 0.05), (-0.1, 0.2, -0.08), (0.05, 0.1, 0.0))


def _case(name):
    """(grids [P, H, W], pts, mask, states [P, 4], max_iter)."""
    if name == "three_grids":          # test_batched_matches_generic
        grid, pts, mask = _world(np.random.default_rng(0), 200)
        grids = np.stack([grid, np.clip(grid + 1, 0, 25),
                          np.clip(grid + 2, 0, 25)]).astype(np.int8)
        return grids, pts, mask, _states(*STATES3), 40
    if name == "single":               # test_unbatched_single_particle
        grid, pts, mask = _world(np.random.default_rng(3), 150)
        return grid[None], pts, mask, _states(STATES3[0]), 40
    if name == "two_grids":            # test_matches_gn_solve_kernel
        grid, pts, mask = _world(np.random.default_rng(7), 170)
        grids = np.stack([grid, np.clip(grid + 3, 0, 25)]).astype(np.int8)
        return grids, pts, mask, _states((0.2, -0.1, 0.03),
                                         (-0.15, 0.1, -0.06)), 40
    grid, pts, mask = _world(np.random.default_rng(5), 180)
    grids = np.stack([grid, np.clip(grid + 1, 0, 25)]).astype(np.int8)
    if name == "max_iter":             # every particle stops at the cap
        return grids, pts, mask, _states(*STATES3[:2]), 2
    if name == "all_masked":           # no beam: stop before any step
        return grids, pts, np.zeros_like(mask), _states(*STATES3[:2]), 40
    # beams partly outside the grid (corners read max_dist)
    return grids, pts, mask, _states((-2.5, 0.3, 0.1), (1.0, 3.5, -0.2)), 40


def _jax_solve(mod, grids, pts, mask, states, max_iter):
    kw = dict(KW, max_iter=max_iter, want_lik=True, impl="interpret")
    p = grids.shape[0]
    out = jax.vmap(lambda g, o, s: mod.solve_window_sq(
        g, o, s, jnp.asarray(pts), jnp.asarray(mask), **kw))(
        jnp.asarray(grids), jnp.asarray(np.tile(ORG, (p, 1))),
        jnp.asarray(states))
    return [np.asarray(a) for a in out]


def _port_solve(grids, pts, mask, states, max_iter):
    p = grids.shape[0]
    out = tgb.solve_window_sq(torch.as_tensor(grids),
                              torch.as_tensor(np.tile(ORG, (p, 1))),
                              torch.as_tensor(states), torch.as_tensor(pts),
                              torch.as_tensor(mask), max_iter=max_iter,
                              want_lik=True, **KW)
    return [a.numpy() for a in out]


def _assert_solves_agree(got, want):
    (st, it, chi2, sse), (jst, jit, jchi2, jsse) = got, want
    np.testing.assert_array_equal(it, jit)
    np.testing.assert_allclose(st, jst, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(chi2, jchi2, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sse, jsse, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", ["three_grids", "single", "two_grids",
                                  "max_iter", "all_masked", "outside"])
def test_gn_batch_plain_matches_jax_kernel(case):
    grids, pts, mask, states, max_iter = _case(case)
    got = _port_solve(grids, pts, mask, states, max_iter)
    _assert_solves_agree(got, _jax_solve(jgb, grids, pts, mask, states,
                                         max_iter))
    it = got[1]
    if case == "max_iter":
        assert (it == max_iter).all()
    elif case == "all_masked":
        assert (it == 0).all() and (got[2] == 0).all()
        np.testing.assert_array_equal(got[0], states)
    elif case in ("three_grids", "single"):
        assert it.sum() >= 3          # the world drives the loop


def test_gn_batch_plain_matches_jax_gn_solve():
    """B4 and B6 share one contract: the plain B6 against the JAX
    single-particle whole-solve kernel in interpret mode."""
    grids, pts, mask, states, max_iter = _case("two_grids")
    _assert_solves_agree(_port_solve(grids, pts, mask, states, max_iter),
                         _jax_solve(jgs, grids, pts, mask, states, max_iter))


# ---------------------------------------------------------------------------
# batched B1 and B3
# ---------------------------------------------------------------------------

def _batched_streams(case, p=3, n=3000, h=64, w=128):
    rng = np.random.default_rng(11)
    ly = rng.integers(0, h, (p, n)).astype(np.int32)
    lx = rng.integers(0, w, (p, n)).astype(np.int32)
    if case == "duplicates":
        ly[:, : n // 2], lx[:, : n // 2] = 5, 9
        ly[1, n // 2:], lx[1, n // 2:] = 5, 9
    elif case == "sentinels":
        # the sentinel row ly == h with in-range columns: a flat layout
        # that did not check the row would spill into the next grid
        sent = rng.uniform(size=(p, n)) < 0.3
        ly = np.where(sent, h, ly)
        ly[0, :50], lx[0, :50] = h, np.arange(50)
    return ly, lx, h, w


@pytest.mark.parametrize("impl", ["interpret_i8", "xla"])
@pytest.mark.parametrize("case", ["random", "duplicates", "sentinels"])
def test_batched_deposit_bit_exact(case, impl):
    ly, lx, h, w = _batched_streams(case)
    want = jax.vmap(lambda a, b: jsm.scatter_counts_2d(a, b, h, w,
                                                       impl=impl))(
        jnp.asarray(ly), jnp.asarray(lx))
    got = tsm.deposit_counts(torch.as_tensor(ly), torch.as_tensor(lx), h, w)
    assert got.shape == (3, h, w) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # particle by particle, the 2-D entry point gives the same grids
    for q in range(3):
        np.testing.assert_array_equal(
            tsm.deposit_counts(torch.as_tensor(ly[q]), torch.as_tensor(lx[q]),
                               h, w).numpy(), got[q].numpy())


@pytest.mark.parametrize("p", [1, 3])
def test_deposit_pair_plain_matches_jax(p):
    """B1's pair (the hit counts, and the hit plus free-space counts) on
    raycast streams of ``p`` particles against two JAX
    ``scatter_counts_2d`` calls (Pallas interpret, vmapped over the
    particles) and an add: bit-exact."""
    hit_ly, hit_lx, h, w = (a[:p] if isinstance(a, np.ndarray) else a
                            for a in _batched_streams("sentinels", n=200))
    free_ly, free_lx = (a[:p] for a in _batched_streams(
        "duplicates", n=200 * 17)[:2])

    def jcounts(ly, lx):
        return np.asarray(jax.vmap(lambda a, b: jsm.scatter_counts_2d(
            a, b, h, w, impl="interpret_i8"))(jnp.asarray(ly),
                                              jnp.asarray(lx)))

    occ_w = jcounts(hit_ly, hit_lx)
    vis_w = occ_w + jcounts(free_ly, free_lx)
    t = [torch.as_tensor(a) for a in (hit_ly, hit_lx, free_ly, free_lx)]
    if p == 1:
        t = [a[0] for a in t]
        occ_w, vis_w = occ_w[0], vis_w[0]
    occ, vis = tsm.deposit_pair(*t, h, w)
    assert occ.dtype == vis.dtype == torch.int32
    np.testing.assert_array_equal(occ.numpy(), occ_w)
    np.testing.assert_array_equal(vis.numpy(), vis_w)


@pytest.mark.parametrize("cap,r", [(100, 10), (25, 5)])
def test_batched_edt_bit_exact(cap, r):
    rng = np.random.default_rng(r)
    dens = np.array([0.0, 0.01, 0.3])[:, None, None]
    obst = rng.random((3, 72, 96)) < dens
    got = tedt.edt2d(torch.as_tensor(obst), cap, r)
    want = jax.vmap(lambda m: jdist.edt2d(m, cap, r))(jnp.asarray(obst))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# particle-filter device functions
# ---------------------------------------------------------------------------

PF_KW = dict(particles=8, resolution=0.1, patch_size=16, max_range=8.0,
             capacity=1024, trans_thresh=0.3, rot_thresh=0.3, max_iter=30,
             seed=7)


@pytest.mark.parametrize("odelta", [(0.3, 0.1, 0.2), (-0.05, 0.4, -3.0),
                                    (0.0, 0.0, 0.0)])
def test_draw_from_motion_matches(odelta):
    jo, to = jpf.PFSlam2DOptions(**PF_KW), tpf.PFSlam2DOptions(**PF_KW)
    rng = np.random.default_rng(1)
    xyr = rng.normal(0, 2, (8, 3))
    poses = np.stack([xyr[:, 0], xyr[:, 1], np.cos(xyr[:, 2]),
                      np.sin(xyr[:, 2])], -1).astype(np.float32)
    od = np.array([odelta[0], odelta[1], np.cos(odelta[2]),
                   np.sin(odelta[2])], np.float32)
    key = jax.random.PRNGKey(3)
    want = jpf.draw_from_motion(jo, key, jnp.asarray(od), jnp.asarray(poses))
    eps = np.array(jax.random.normal(key, (8, 3)))
    got = tpf.draw_from_motion(to, torch.as_tensor(eps), torch.as_tensor(od),
                               torch.as_tensor(poses))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("n,spread,seed", [(16, 1.0, 0), (16, 60.0, 1),
                                           (32, 10.0, 2), (32, 200.0, 3),
                                           (16, 200.0, 4)])
def test_weights_and_resample_match(n, spread, seed):
    """Normalise + Neff + systematic resampling on the cases of
    tests/test_pf_units.py: weights and likelihoods spread from none to a
    forced resample; ``idx`` equal, floats to rtol 1e-5."""
    rng = np.random.default_rng(seed)
    kw = dict(PF_KW, particles=n)
    jo, to = jpf.PFSlam2DOptions(**kw), tpf.PFSlam2DOptions(**kw)
    weight = rng.normal(-50, spread, n).astype(np.float32)
    liks = rng.normal(-20, spread, n).astype(np.float32)
    states = rng.normal(0, 1, (n, 4)).astype(np.float32)
    pset = jpf.ParticleSet(jnp.asarray(states), jnp.asarray(weight),
                           jnp.asarray(weight + 1.0), None, None)
    key = jax.random.PRNGKey(seed)
    want = jpf._weights_and_resample(jo, pset, key, jnp.asarray(states),
                                     jnp.asarray(liks))
    u = torch.tensor(np.array(jax.random.uniform(key)))
    got = tpf.weights_and_resample(to, torch.as_tensor(weight),
                                   torch.as_tensor(weight + 1.0),
                                   torch.as_tensor(states),
                                   torch.as_tensor(liks), u)
    idx, pose, w, ws, nw, neff, do = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[0].numpy(), idx)
    assert bool(got[6]) == bool(do)
    np.testing.assert_array_equal(got[1].numpy(), pose)
    for g, x in zip(got[2:6], (w, ws, nw, neff)):
        np.testing.assert_allclose(g.numpy(), x, rtol=1e-5, atol=1e-30)
    if spread >= 200:
        assert bool(do)


def _pf_map_case(res_extra=1):
    """Options, resident org, three particle poses and two scans of the
    simulator for the map-phase tests."""
    kw = dict(PF_KW, resident_extra_patches=res_extra)
    jo, to = jpf.PFSlam2DOptions(**kw), tpf.PFSlam2DOptions(**kw)
    data = jsim.simulate(jsim.SimConfig(
        n_steps=30, seed=2, laser=jsim.LaserSpec(n_beams=120, max_range=8.0)))
    rng = np.random.default_rng(4)
    scans = [pad_scan(data.clouds[k], 256) for k in (3, 4)]
    poses = []
    for k in (3, 4):
        g = data.poses_gt[k]
        d = rng.normal(0, [0.3, 0.3, 0.05], (3, 3))
        poses.append(np.stack([g[0] + d[:, 0], g[1] + d[:, 1],
                               np.cos(g[2] + d[:, 2]),
                               np.sin(g[2] + d[:, 2])], -1).astype(np.float32))
    cfg = jo.mapping_config()
    org = np.asarray(jmap.resident_org(cfg, cfg.geometry.w2m(
        jnp.asarray(data.poses_gt[3][:2], jnp.float32))))
    return jo, to, org, poses, scans


def test_batched_resident_update_bit_exact():
    """Two scans into three particles' resident grids (one shared org):
    the port's batched resident_update against the JAX package's vmapped
    one (``_pf_map_phase``)."""
    jo, to, org, poses, scans = _pf_map_case()
    jcfg, tcfg = jo.mapping_config(), to.mapping_config()
    w = jcfg.resident_window_cells
    jg = (jnp.zeros((3, w, w), jnp.uint16), jnp.zeros((3, w, w), jnp.uint16),
          jnp.full((3, w, w), jcfg.distance.max_sqdist, jnp.int8))
    tg = (torch.zeros((3, w, w), dtype=torch.int32),
          torch.zeros((3, w, w), dtype=torch.int32),
          torch.full((3, w, w), tcfg.distance.max_sqdist, dtype=torch.int8))
    for pose, (p, m, o) in zip(poses, scans):
        jg = jpf._pf_map_phase(jo, jnp.asarray(org), *jg, jnp.asarray(pose),
                               jnp.asarray(p), jnp.asarray(m),
                               jnp.asarray(o))
        tmap.resident_update(tcfg, torch.as_tensor(org), *tg,
                             torch.as_tensor(pose), torch.as_tensor(p),
                             torch.as_tensor(m), torch.as_tensor(o))
        for a, b in zip(tg, jg):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int((tg[0] > 0).sum()) > 100


def test_match_windows_bit_exact():
    """The clipped per-particle sub-window slice of the match phase
    (pf_slam2d.py:387-402): one gather against JAX's vmapped
    dynamic_slice, with poses near and past the window edge."""
    jo, to, org, poses, _ = _pf_map_case()
    cfg = jo.mapping_config()
    w_res, ws_m = cfg.resident_window_cells, cfg.match_window_cells
    assert ws_m < w_res
    rng = np.random.default_rng(6)
    dist = rng.integers(0, 26, (3, w_res, w_res)).astype(np.int8)
    pose = poses[0].copy()
    pose[1, :2] += 6.0                 # clipped at the far edge
    pose[2, :2] -= 9.0                 # clipped at the near edge
    lp = cfg.geometry.w2m(jnp.asarray(pose[:, :2])) - jnp.asarray(org)
    starts = jnp.clip(lp - ws_m // 2, 0, w_res - ws_m)
    want = jax.vmap(lambda d, s: jax.lax.dynamic_slice(
        d, (s[1], s[0]), (ws_m, ws_m)))(jnp.asarray(dist), starts)
    grids, orgs = tpf.match_windows(to, torch.as_tensor(org),
                                    torch.as_tensor(dist),
                                    torch.as_tensor(pose))
    np.testing.assert_array_equal(grids.numpy(), np.asarray(want))
    np.testing.assert_array_equal(orgs.numpy(),
                                  np.asarray(jnp.asarray(org)[None] + starts))
