"""Loc2D's pieces of the port against the JAX package, on the CPU.

* B4 (``ops/gn_solve.py``): the plain version against the JAX whole-solve
  kernel in Pallas interpret mode, on the cases of tests/test_gn_solve.py
  plus a pair of particles with a scan each. State rtol 1e-4 / atol 1e-5,
  equal iterations, chi2 rtol 1e-4, sum_d2 rtol 1e-5: the ten sums are
  reduced in another order (the kernel's block order against the
  interpreter's), so they agree to a few ulp.
* B5 (``ops/match_eval.py``): the plain version against the JAX fused
  evaluation in interpret mode (rtol 1e-5; at 1-2048 beams with cells off
  the window on every side also atol 1e-6 per beam), an all-masked scan,
  strided operand views, and the fused solve loop against the JAX one.
* B7 and B8: bit-exact against the interpret-mode ``pallas_call``s.
* The pool-side reads (``active_keys``, ``cell_distance``,
  ``interp_pool``, the simple occupancy map, ``map_bounds``), the float
  window interpolation and ``covariance_from_eval``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos import loc2d as jloc
from iris_lama_tpu.core import lie as jlie
from iris_lama_tpu.match import match_surface_2d as jmatch
from iris_lama_tpu.nlls import robust as jrobust
from iris_lama_tpu.nlls import solver as jsolver
from iris_lama_tpu.ops import gn_solve as jgs
from iris_lama_tpu.ops import match_eval as jme
from iris_lama_tpu.sdm import distance as jdist
from iris_lama_tpu.sdm import geometry as jgeo
from iris_lama_tpu.sdm import occupancy as jocc
from iris_lama_tpu.sdm import pool as jpool

from iris_lama_tpu_torch.algos import loc2d as tloc
from iris_lama_tpu_torch.match import match_surface_2d as tmatch
from iris_lama_tpu_torch.nlls import robust as trobust
from iris_lama_tpu_torch.nlls import solver as tsolver
from iris_lama_tpu_torch.ops import gn_solve as tgs
from iris_lama_tpu_torch.ops import match_eval as tme
from iris_lama_tpu_torch.ops import scatter_pallas as tsp
from iris_lama_tpu_torch.ops import scatter_sorted as tss
from iris_lama_tpu_torch.sdm import distance as tdist
from iris_lama_tpu_torch.sdm import geometry as tgeo
from iris_lama_tpu_torch.sdm import occupancy as tocc
from iris_lama_tpu_torch.sdm import pool as tpool
from iris_lama_tpu_torch.utils.state import TABLE_FIELDS

# the world of tests/test_gn_solve.py: 0.1 m cells, 96 x 96, cap 25
RES, H, W, MAXD = 0.1, 96, 96, 0.5
JGEO = jgeo.MapGeometry(RES, 4, False)
TGEO = tgeo.MapGeometry(RES, 4, False)
ORG = np.array([JGEO.cell_offset] * 2, np.int32)
KW = dict(max_dist=MAXD, res=RES, scale=JGEO.scale,
          cell_offset=JGEO.cell_offset, cauchy_c=0.15, eps1=1e-4, eps2=1e-4,
          max_iter=40)


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


def _world(rng, b):
    """tests/test_gn_solve.py:_world — beams on obstacle surfaces."""
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


# ---------------------------------------------------------------------------
# B4: the whole solve
# ---------------------------------------------------------------------------

def _b4_case(name):
    """(grids [P, H, W], pts [B, 2] or [P, B, 2], mask, states [P, 4],
    want_lik) after the cases of tests/test_gn_solve.py."""
    st0 = (0.25, -0.15, 0.05)
    if name in ("seed0", "seed3"):          # test_kernel_solve_matches_generic
        grid, pts, mask = _world(np.random.default_rng(int(name[-1])), 200)
        return grid[None], pts, mask, _states(st0), False
    if name == "vmapped":                   # test_kernel_solve_vmapped
        grid, pts, mask = _world(np.random.default_rng(1), 170)
        grids = np.stack([grid, np.clip(grid + 1, 0, 25)]).astype(np.int8)
        return grids, pts, mask, _states(st0, (-0.1, 0.2, -0.08)), False
    if name == "want_lik":                  # test_kernel_likelihood_sum
        grid, pts, mask = _world(np.random.default_rng(2), 150)
        return grid[None], pts, mask, _states((0.1, 0.05, 0.0)), True
    if name in ("b257", "b1", "b2049", "b4096"):
        # the edges of the kernel's 256 threads and of the 2048 beams it
        # holds in registers
        grid, pts, mask = _world(np.random.default_rng(6), int(name[1:]))
        if name == "b1":
            mask[:] = True
        return grid[None], pts, mask, _states(st0), True
    # one scan per particle, each on its own world
    worlds = [_world(np.random.default_rng(s), 160) for s in (4, 5)]
    grids = np.stack([w[0] for w in worlds])
    pts = np.stack([w[1] for w in worlds])
    mask = np.stack([w[2] for w in worlds])
    return grids, pts, mask, _states(st0, (0.1, 0.2, -0.06)), True


@pytest.mark.parametrize("case", ["seed0", "seed3", "vmapped", "want_lik",
                                  "per_particle_scans", "b257", "b1",
                                  "b2049", "b4096"])
def test_gn_solve_plain_matches_jax_kernel(case):
    grids, pts, mask, states, want_lik = _b4_case(case)
    p = grids.shape[0]
    orgs = np.tile(ORG, (p, 1))
    kw = dict(KW, want_lik=want_lik)
    per = pts.ndim == 3
    jout = jax.vmap(
        lambda g, o, s, q, m: jgs.solve_window_sq(g, o, s, q, m, **kw,
                                                  impl="interpret"),
        in_axes=(0, 0, 0, 0 if per else None, 0 if per else None))(
        jnp.asarray(grids), jnp.asarray(orgs), jnp.asarray(states),
        jnp.asarray(pts), jnp.asarray(mask))
    st, it, chi2, sse = (a.numpy() for a in tgs.solve_window_sq(
        T(grids), T(orgs), T(states), T(pts), T(mask), **kw))
    jst, jit, jchi2, jsse = (np.asarray(a) for a in jout)
    np.testing.assert_array_equal(it, jit)
    np.testing.assert_allclose(st, jst, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(chi2, jchi2, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sse, jsse, rtol=1e-5, atol=1e-6)
    # the world drives the loop (one beam cannot: A is singular)
    assert it.sum() >= (3 if pts.shape[-2] > 1 else 0)
    if want_lik:
        assert (sse > 0).all()


def test_solve_route_matches_jax_generic():
    """``solve_window(route="solve")`` (B4 at P = 1) against the JAX generic
    solver on the float window — test_kernel_solve_matches_generic."""
    grid, pts, mask = _world(np.random.default_rng(0), 200)
    st0 = _states((0.25, -0.15, 0.05))[0]
    opts = jsolver.SolverOptions(max_iterations=40, strategy="gn",
                                 robust=jrobust.CAUCHY_SCAN)
    meters = jnp.sqrt(jnp.asarray(grid, jnp.float32)) * jnp.float32(RES)
    ref = jmatch.solve_window(meters, jnp.asarray(ORG), JGEO, MAXD,
                              jnp.asarray(pts), jnp.asarray(mask),
                              jnp.asarray(st0), opts)
    topts = tsolver.SolverOptions(max_iterations=40, strategy="gn",
                                  robust=trobust.CAUCHY_SCAN)
    out = tmatch.solve_window(T(grid), T(ORG), TGEO, MAXD, T(pts), T(mask),
                              T(st0), topts, route="solve")
    assert int(out.iterations) == int(ref.iterations) >= 3
    np.testing.assert_allclose(out.state.numpy(), np.asarray(ref.state),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(out.chi2), float(ref.chi2), rtol=1e-4)


@pytest.mark.parametrize("route", ["solve", "fused", "bogus"])
def test_kernel_routes_refuse_what_they_cannot_serve(route):
    lm = tsolver.SolverOptions(strategy="lm", robust=trobust.CAUCHY_SCAN)
    with pytest.raises(ValueError):
        tmatch.check_kernel_route(route, lm)
    gn = tsolver.SolverOptions(robust=trobust.CAUCHY_SCAN)
    if route != "bogus":
        with pytest.raises(ValueError):       # a float window
            tmatch.check_kernel_route(route, gn, torch.float32)
        tmatch.check_kernel_route(route, gn)


# ---------------------------------------------------------------------------
# B5: the fused evaluation, and the fused solve loop
# ---------------------------------------------------------------------------

def _sums_args(grid, pts, mask, state):
    hits = jlie.se2_apply(state[:, None, :], pts)
    mi, mu = JGEO.w2m_frac(hits)
    loc = mi - jnp.asarray(ORG)
    fm = jnp.broadcast_to(jnp.asarray(mask, jnp.float32), hits.shape[:-1])
    return (jnp.broadcast_to(jnp.asarray(grid), (hits.shape[0],) +
                             grid.shape),
            loc[..., 1], loc[..., 0], mu[..., 0], mu[..., 1],
            hits[..., 0], hits[..., 1], fm)


@pytest.mark.parametrize("case", ["single", "vmapped", "unit_weights"])
def test_gn_eval_plain_matches_jax_kernel(case):
    """tests/test_match_eval.py: test_kernel_sums_match_jnp (seed 0, one
    state) and test_kernel_sums_vmapped (seed 1, three states); the third
    case takes unit weights."""
    seed, b = (1, 130) if case == "vmapped" else (0, 170)
    grid, pts, mask = _world(np.random.default_rng(seed), b)
    states = (_states((0.3, -0.2, 0.0), (0.1, 0.4, 0.2), (-0.2, 0.0, -0.1))
              if case == "vmapped" else _states((0.3, -0.2, 0.1)))
    args = _sums_args(grid, jnp.asarray(pts), mask, jnp.asarray(states))
    kw = dict(max_dist=MAXD, res=RES, scale=JGEO.scale,
              cauchy_c=0.0 if case == "unit_weights" else 0.15)
    want = np.asarray(jax.vmap(lambda *a: jme.gn_eval_sq(
        *a, **kw, impl="interpret"))(*args))
    targs = [T(np.asarray(a)) for a in args]
    got = tme.gn_eval_sq(*targs, **kw)
    assert got.shape == (len(states), tme.N_OUT)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the unbatched entry point gives particle 0's row
    one = tme.gn_eval_sq(targs[0][0], *(t[0] for t in targs[1:]), **kw)
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


def _eval_operands(rng, p, b, masked=False):
    """B5's operands drawn directly on a 40 x 52 window (cap 25): cells
    up to 3 off the window, beams 0-3 off its top, bottom, left and right
    edge, fractions in [0, 1), hits within 5 m, 90% of the beams kept (none
    when ``masked``)."""
    h, w = 40, 52
    grid = rng.integers(0, 26, (p, h, w)).astype(np.int8)
    ly = rng.integers(-3, h + 3, (p, b)).astype(np.int32)
    lx = rng.integers(-3, w + 3, (p, b)).astype(np.int32)
    for i, (y, x) in enumerate(((-1, 5), (h - 1, 7), (9, -1), (11, w - 1))):
        if i < b:
            ly[:, i], lx[:, i] = y, x
    mux, muy = (rng.uniform(size=(p, b)).astype(np.float32)
                for _ in range(2))
    hx, hy = (rng.uniform(-5, 5, (p, b)).astype(np.float32)
              for _ in range(2))
    keep = np.zeros((p, b), bool) if masked else rng.uniform(size=(p, b)) < 0.9
    return grid, ly, lx, mux, muy, hx, hy, keep.astype(np.float32)


def _jax_eval(args, kw):
    """The JAX fused evaluation in interpret mode: [10] for one particle,
    [P, 10] (vmapped) for P."""
    jargs = [jnp.asarray(a) for a in args]
    if args[0].ndim == 2:
        return np.asarray(jme.gn_eval_sq(*jargs, **kw, impl="interpret"))
    return np.asarray(jax.vmap(lambda *a: jme.gn_eval_sq(
        *a, **kw, impl="interpret"))(*jargs))


@pytest.mark.parametrize("weights", ["cauchy", "unit"])
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("b", [1, 255, 257, 1100, 2048, 2049, 4096])
def test_gn_eval_plain_matches_jax_at_edges(b, p, weights):
    """B5's plain version at the edges of the kernel's design — 1 to 4096
    beams (one to eight a summation lane in registers, then the further
    beams read again), one window or three, unit and
    Cauchy weights, cells off the window on every side — against the JAX
    fused evaluation in interpret mode: rtol 1e-5, plus atol 1e-6 times
    the beam count (the ten sums are reduced in another order, and a sum
    whose terms cancel keeps the absolute error of its parts)."""
    args = _eval_operands(np.random.default_rng(b + p), p, b)
    if p == 1:
        args = tuple(a[0] for a in args)
    kw = dict(max_dist=MAXD, res=RES, scale=JGEO.scale,
              cauchy_c=0.15 if weights == "cauchy" else 0.0)
    want = _jax_eval(args, kw)
    got = tme.gn_eval_sq(*(T(a) for a in args), **kw)
    assert got.shape == want.shape == ((tme.N_OUT,) if p == 1
                                       else (p, tme.N_OUT))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * b)


@pytest.mark.parametrize("p", [1, 3])
def test_gn_eval_plain_all_masked_scan(p):
    """An all-masked scan: every sum is zero, in both packages."""
    args = _eval_operands(np.random.default_rng(11), p, 300, masked=True)
    if p == 1:
        args = tuple(a[0] for a in args)
    kw = dict(max_dist=MAXD, res=RES, scale=JGEO.scale, cauchy_c=0.15)
    got = tme.gn_eval_sq(*(T(a) for a in args), **kw).numpy()
    np.testing.assert_array_equal(got, np.zeros_like(got))
    np.testing.assert_array_equal(_jax_eval(args, kw), got)


@pytest.mark.parametrize("batched", [False, True])
def test_gn_eval_takes_strided_views(batched):
    """The operands as the fused loop passes them — the columns of [.., 2]
    cell, fraction and hit tensors — and a mask expanded over the
    particles (stride 0) give what the contiguous operands give."""
    p, b = 3, 300
    grid, ly, lx, mux, muy, hx, hy, fm = (T(a) for a in _eval_operands(
        np.random.default_rng(12), p, b))
    fm = fm[0]
    loc, mu, hits = (torch.stack(c, -1) for c in ((lx, ly), (mux, muy),
                                                  (hx, hy)))
    views = (loc[..., 1], loc[..., 0], mu[..., 0], mu[..., 1], hits[..., 0],
             hits[..., 1], fm.expand(p, b))
    assert not any(v.is_contiguous() for v in views)
    dense = [v.contiguous() for v in views]
    if not batched:
        grid, views, dense = grid[0], [v[0] for v in views], \
            [v[0] for v in dense]
    kw = dict(max_dist=MAXD, res=RES, scale=JGEO.scale, cauchy_c=0.15)
    assert torch.equal(tme.gn_eval_sq(grid, *views, **kw),
                       tme.gn_eval_sq(grid, *dense, **kw))


def test_fused_solve_matches_jax_fused():
    """test_fused_solve_matches_generic's case: the port's fused loop (B5
    per evaluation) against the JAX fused loop."""
    grid, pts, mask = _world(np.random.default_rng(2), 200)
    st0 = _states((0.25, -0.15, 0.05))[0]
    opts = jsolver.SolverOptions(max_iterations=40, strategy="gn",
                                 robust=jrobust.CAUCHY_SCAN)
    ref = jmatch._solve_window_fused(jnp.asarray(grid), jnp.asarray(ORG),
                                     JGEO, MAXD, jnp.asarray(pts),
                                     jnp.asarray(mask), jnp.asarray(st0),
                                     opts)
    topts = tsolver.SolverOptions(max_iterations=40, strategy="gn",
                                  robust=trobust.CAUCHY_SCAN)
    reads = tsolver.host_read.count
    out = tmatch.solve_window(T(grid), T(ORG), TGEO, MAXD, T(pts), T(mask),
                              T(st0), topts, route="fused")
    assert int(out.iterations) == int(ref.iterations) >= 2
    np.testing.assert_allclose(out.state.numpy(), np.asarray(ref.state),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(out.chi2), float(ref.chi2), rtol=1e-4,
                               atol=1e-6)
    # one host read per STOP_CHECK_EVERY masked steps
    steps = int(out.iterations) + 1
    assert tsolver.host_read.count - reads == -(-steps //
                                                tsolver.STOP_CHECK_EVERY)


# ---------------------------------------------------------------------------
# B7 and B8: the value scatters
# ---------------------------------------------------------------------------

def test_scatter_add_2d_matches_pallas_interpret():
    """tests/test_distance.py::test_pallas_scatter_matches_xla_interpret."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from iris_lama_tpu.ops import scatter_pallas as jsp

    rng = np.random.default_rng(0)
    n, w = jsp.CHUNK * 2, 256
    ly = rng.integers(0, w, n).astype(np.int32)
    lx = rng.integers(0, w, n).astype(np.int32)
    v = rng.integers(-3, 4, n).astype(np.int32)
    idx_spec = pl.BlockSpec((jsp.CHUNK,), lambda i: (i,),
                            memory_space=pltpu.SMEM)
    call = pl.pallas_call(
        jsp._scatter_kernel, grid=(n // jsp.CHUNK,),
        in_specs=[idx_spec, idx_spec, idx_spec],
        out_specs=pl.BlockSpec((w, w), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((w, w), jnp.int32), interpret=True)
    want = np.asarray(call(jnp.asarray(ly), jnp.asarray(lx), jnp.asarray(v)))
    got = tsp.scatter_add_2d(T(ly), T(lx), T(v), (w, w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_add_sorted_matches_pallas_interpret():
    """tests/test_distance.py::test_sorted_scatter_matches_xla_interpret;
    pack_updates bit-exact, and the unsorted words give the same grid."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from iris_lama_tpu.ops import scatter_sorted as jss

    rng = np.random.default_rng(1)
    n, h, w = jss.CHUNK * 2 + 100, 256, 384
    ly = rng.integers(0, h, n).astype(np.int32)
    lx = rng.integers(0, w, n).astype(np.int32)
    v = rng.integers(0, 2, n).astype(np.int32)
    jpacked = jss.pack_updates(jnp.asarray(ly), jnp.asarray(lx),
                               jnp.asarray(v))
    tpacked = tss.pack_updates(T(ly), T(lx), T(v))
    np.testing.assert_array_equal(tpacked.numpy(), np.asarray(jpacked))
    packed = jnp.sort(jpacked)
    pad = (-n) % jss.CHUNK
    last_code = ((h // 8 - 1) << 9) | (w // 128 - 1)
    packed = jnp.concatenate([packed,
                              jnp.full(pad, last_code << 11, jnp.int32)])
    n_chunks = packed.shape[0] // jss.CHUNK
    call = pl.pallas_call(
        functools.partial(jss._kernel, n_tx=w // 128, n_chunks=n_chunks),
        grid=(n_chunks,),
        in_specs=[pl.BlockSpec((jss.CHUNK,), lambda i: (i,),
                               memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((h, w), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((h, w), jnp.int32),
        scratch_shapes=[pltpu.VMEM((8, 128), jnp.int32),
                        pltpu.SMEM((1,), jnp.int32)],
        interpret=True)
    want = np.asarray(call(packed))
    np.testing.assert_array_equal(
        tss.scatter_add_2d_sorted(T(ly), T(lx), T(v), (h, w)).numpy(), want)
    np.testing.assert_array_equal(
        tss.scatter_add_sorted(tpacked, (h, w)).numpy(), want)
    with pytest.raises(ValueError):
        tss.scatter_add_sorted(tpacked, (h, w - 64))


@pytest.mark.parametrize("call", ["gn_solve", "gn_solve_per_particle",
                                  "gn_eval", "scatter_add_2d",
                                  "scatter_add_sorted"])
def test_loc_kernel_wrappers_never_fall_back(call):
    """A tensor that is not on the CPU goes to the kernel or raises — here
    a meta tensor, which the launchers refuse."""
    m = dict(device="meta")

    def e(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, **m)

    i32 = torch.int32
    with pytest.raises(ValueError):
        if call.startswith("gn_solve"):
            scan = (3, 8) if call.endswith("particle") else (8,)
            tgs.solve_window_sq(e((3, 4, 4), torch.int8), e((3, 2), i32),
                                e((3, 4)), e((*scan, 2)),
                                e(scan, torch.bool), **KW)
        elif call == "gn_eval":
            tme.gn_eval_sq(e((4, 4), torch.int8), e(8, i32), e(8, i32),
                           *(e(8) for _ in range(5)), max_dist=MAXD,
                           res=RES, scale=10.0, cauchy_c=0.15)
        elif call == "scatter_add_2d":
            tsp.scatter_add_2d(e(8, i32), e(8, i32), e(8, i32), (8, 8))
        else:
            tss.scatter_add_sorted(e(8, i32), (8, 128))


# ---------------------------------------------------------------------------
# the pool-side reads and the float window
# ---------------------------------------------------------------------------

CAP, LEN = 64, 16


@functools.lru_cache(maxsize=None)
def _pool_map():
    """A JAX pool with 5 of its patches removed again (tombstones, holes in
    the free list), random distances (10% obstacles) and random tri-state
    cells; the port's copy of it."""
    rng = np.random.default_rng(0)
    c = jgeo.CENTER_PATCH
    pcs = sorted({(c + int(dx), c + int(dy))
                  for dx, dy in rng.integers(-4, 4, (40, 2))})
    keys = np.array([(px << jgeo.PKEY_BITS) | py for px, py in pcs],
                    np.int32)
    table = jpool.table_init(CAP)
    table, _ = jpool.table_insert_unique(table, jnp.asarray(keys))
    table, _ = jpool.table_remove(table, jnp.asarray(keys[::7]))
    dist = rng.uniform(0, MAXD, (CAP + 1, LEN, LEN)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.1] = 0.0
    cells = rng.integers(-1, 2, (CAP + 1, LEN, LEN)).astype(np.int8)
    ttable = tpool.PatchTable(*(T(np.asarray(getattr(table, f)), torch.int32)
                                for f in TABLE_FIELDS))
    jm = (table, jnp.asarray(dist), jnp.asarray(cells))
    tm = (ttable, T(dist), T(cells))
    return jm, tm


def _world_xy(n, seed):
    """World points over the pool's patches and beyond them."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-7.0, 6.0, (n, 2)).astype(np.float32)


def test_active_keys_and_map_bounds_exact():
    (jt, _, _), (tt, _, _) = _pool_map()
    jk, jmask = jpool.active_keys(jt)
    tk, tmask = tpool.active_keys(tt)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert 0 < int(tmask.sum()) < CAP
    for a, b in zip(tloc.map_bounds(tt, TGEO), jloc.map_bounds(jt, JGEO)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cell_distance_and_occupancy_exact():
    (jt, jd, jc), (tt, td, tc) = _pool_map()
    xy = _world_xy(3000, 1)
    cells = JGEO.w2m(jnp.asarray(xy))
    tcells = T(np.asarray(cells))
    np.testing.assert_array_equal(
        tdist.cell_distance(tt, td, TGEO, tcells, MAXD).numpy(),
        np.asarray(jdist.cell_distance(jt, jd, JGEO, cells, MAXD)))
    jocc_state = jocc.SimpleOccupancyState(jt, jc)
    tocc_state = tocc.SimpleOccupancyState(tt, tc)
    for name in ("free", "occupied", "unknown"):
        got = getattr(tocc, f"simple_is_{name}")(tocc_state, TGEO, tcells)
        want = getattr(jocc, f"simple_is_{name}")(jocc_state, JGEO, cells)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < len(xy)


def test_interp_pool_matches():
    (jt, jd, _), (tt, td, _) = _pool_map()
    xy = _world_xy(3000, 2)
    jd_, jg = jdist.interp_pool(jt, jd, JGEO, jnp.asarray(xy), MAXD)
    td_, tg = tdist.interp_pool(tt, td, TGEO, T(xy), MAXD)
    np.testing.assert_allclose(td_.numpy(), np.asarray(jd_), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)


def test_interp_window_float_matches():
    rng = np.random.default_rng(3)
    grid = rng.uniform(0, MAXD, (40, 56)).astype(np.float32)
    org = np.array([JGEO.cell_offset - 5, JGEO.cell_offset - 3], np.int32)
    # points over the window and up to two cells beyond each edge
    xy = rng.uniform([-0.7, -0.5], [5.3, 4.0], (4000, 2)).astype(np.float32)
    jd_, jg = jdist.interp_window(jnp.asarray(grid), jnp.asarray(org), JGEO,
                                  jnp.asarray(xy), MAXD)
    td_, tg = tdist.interp_window(T(grid), T(org), TGEO, T(xy), MAXD)
    np.testing.assert_allclose(td_.numpy(), np.asarray(jd_), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    assert (td_.numpy() == np.float32(MAXD)).any()   # off-window corners


def test_covariance_full_rank_matches():
    rng = np.random.default_rng(4)
    r = rng.normal(0, 0.1, 300).astype(np.float32)
    J = rng.normal(0, 1.0, (300, 3)).astype(np.float32)
    want = np.asarray(jsolver.covariance_from_eval(
        jnp.asarray(r), jnp.asarray(J), jrobust.CAUCHY_SCAN))
    got = tsolver.covariance_from_eval(T(r), T(J), trobust.CAUCHY_SCAN)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_covariance_rank_deficient_exact():
    """No beam constrains the heading: J'J is singular and the
    pseudo-inverse takes over, the null direction filled with 3.0."""
    J = np.zeros((64, 3), np.float32)
    J[::2, 0] = 1.0
    J[1::2, 1] = 0.5
    r = np.full(64, 0.2, np.float32)
    want = np.asarray(jsolver.covariance_from_eval(
        jnp.asarray(r), jnp.asarray(J), jrobust.UNIT))
    got = tsolver.covariance_from_eval(T(r), T(J), trobust.UNIT).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2, 2] == 3.0


def test_loc2d_options_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jloc.Loc2DOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(tloc.Loc2DOptions)}
    assert tf == jf
    assert (tloc.Loc2DOptions().solver_options().robust
            == trobust.CAUCHY_SCAN)
