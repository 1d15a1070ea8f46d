"""The PyTorch port (iris_lama_tpu_torch) against the JAX package, module by
module, on the CPU at small sizes.

Integer results (cells, counts, tables, EDTs) must be bit-equal; float
results hold to the stated tolerances (XLA's CPU code fuses multiply-adds
and has its own sin/cos, so a few ulp differ). The kernels' plain versions
run here; the JAX Pallas kernels run in interpret mode.
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.core import lie as jlie
from iris_lama_tpu.match import match_surface_2d as jmatch
from iris_lama_tpu.nlls import robust as jrobust
from iris_lama_tpu.nlls import solver as jsolver
from iris_lama_tpu.ops import edt_pallas as jedt
from iris_lama_tpu.ops import scatter_matmul as jsm
from iris_lama_tpu.ops import select4 as js4
from iris_lama_tpu.sdm import distance as jdist
from iris_lama_tpu.algos.slam2d import Slam2DOptions as JOptions
from iris_lama_tpu.sdm import geometry as jgeo
from iris_lama_tpu.sdm import pool as jpool
from iris_lama_tpu.sdm import raycast as jray
from iris_lama_tpu.sdm import window as jwin
from iris_lama_tpu.utils import simulator as jsim

from iris_lama_tpu_torch.algos import slam2d as tslam
from iris_lama_tpu_torch.core import lie as tlie
from iris_lama_tpu_torch.match import match_surface_2d as tmatch
from iris_lama_tpu_torch.nlls import robust as trobust
from iris_lama_tpu_torch.nlls import solver as tsolver
from iris_lama_tpu_torch.ops import edt_pallas as tedt
from iris_lama_tpu_torch.ops import gn_batch as tgb
from iris_lama_tpu_torch.ops import scatter_matmul as tsm
from iris_lama_tpu_torch.ops import select4 as ts4
from iris_lama_tpu_torch.sdm import distance as tdist
from iris_lama_tpu_torch.sdm import geometry as tgeo
from iris_lama_tpu_torch.sdm import pool as tpool
from iris_lama_tpu_torch.sdm import raycast as tray
from iris_lama_tpu_torch.sdm import window as twin
from iris_lama_tpu_torch.utils import simulator as tsim

REPO = pathlib.Path(__file__).resolve().parents[1]


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


def N(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# host copies and the no-JAX rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,seed", [("office", 0), ("office", 3),
                                        ("corridor", 1)])
def test_simulator_copy_byte_identical(world, seed):
    kw = dict(n_steps=30, seed=seed, world=world,
              laser=jsim.LaserSpec(n_beams=90, max_range=8.0))
    a = jsim.simulate(jsim.SimConfig(**kw))
    kw["laser"] = tsim.LaserSpec(n_beams=90, max_range=8.0)
    b = tsim.simulate(tsim.SimConfig(**kw))
    assert a.poses_gt.tobytes() == b.poses_gt.tobytes()
    assert a.timestamps.tobytes() == b.timestamps.tobytes()
    for oa, ob in zip(a.odometry, b.odometry):
        assert oa.xyr().tobytes() == ob.xyr().tobytes()
    for ca, cb in zip(a.clouds, b.clouds):
        assert ca.points.tobytes() == cb.points.tobytes()
        assert ca.sensor_origin.tobytes() == cb.sensor_origin.tobytes()


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted((REPO / "iris_lama_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "iris_lama_tpu")]
    assert not bad, bad


def test_entry_point_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tslam.Slam2D(tslam.Slam2DOptions())
    tslam.Slam2D(tslam.Slam2DOptions(capacity=16), device="cpu")


def _one_scan(opts):
    """A port Slam2D on the CPU built from ``opts`` and fed two scans."""
    data = tsim.simulate(tsim.SimConfig(
        n_steps=20, seed=2, laser=tsim.LaserSpec(n_beams=60, max_range=6.0)))
    slam = tslam.Slam2D(opts, device="cpu")
    slam.set_prior(tslam.Pose2D(*data.poses_gt[0]))
    for k in (0, 3):
        assert slam.update(data.clouds[k], data.odometry[k])
    return slam


SMALL = dict(resolution=0.1, patch_size=16, max_range=6.0, capacity=256)


@pytest.mark.parametrize("field", ["transient_map", "use_compression",
                                   "detailed_summary", "create_summary"])
def test_unported_options_raise(field):
    """These options were once unported and raised; each is ported now:
    the driver builds on the CPU and maps a scan with the option on."""
    kw = {field: True}
    if field == "detailed_summary":
        kw["create_summary"] = True    # the phases go into the summary
    slam = _one_scan(tslam.Slam2DOptions(**SMALL, **kw))
    assert int(slam.map.table.num_patches()) > 0
    if field == "transient_map":
        assert slam.cfg.transient
    elif field == "use_compression":
        # the spill tier runs the pool-per-scan path
        assert slam._spill is not None and not slam._resident
        assert slam.full_map() is slam.map
    else:
        s = slam.summary
        assert len(s.time_total) == 2 and slam.memory_usage() > 0
        split = field == "detailed_summary"
        assert (s.time_solving[1] != s.time_total[1]) == split


def test_pool_path_option_raises():
    """``resident_window=False`` (the pool-per-scan path) no longer raises:
    the driver builds on the CPU and maps a scan into the pool."""
    slam = _one_scan(tslam.Slam2DOptions(**SMALL, resident_window=False))
    assert slam._res_org is None and slam.n_reorgs == 0
    assert int(slam.map.table.num_patches()) > 0


@pytest.mark.parametrize("call", ["deposit", "select4", "edt",
                                  "deposit_batched", "edt_batched",
                                  "gn_batch", "gn_batch_per_particle"])
def test_kernel_wrappers_never_fall_back(call):
    """A tensor that is not on the CPU goes to the kernel or raises — here
    a meta tensor, which the launchers refuse."""
    m = dict(device="meta")
    with pytest.raises(ValueError):
        if call == "deposit":
            tsm.deposit_counts(torch.empty(8, dtype=torch.int32, **m),
                               torch.empty(8, dtype=torch.int32, **m), 4, 4)
        elif call == "select4":
            ts4.select4_sq(torch.empty((4, 4), dtype=torch.int8, **m),
                           torch.empty(8, dtype=torch.int32, **m),
                           torch.empty(8, dtype=torch.int32, **m))
        elif call == "edt":
            tedt.edt2d(torch.empty((4, 4), dtype=torch.bool, **m), 25, 5)
        elif call == "deposit_batched":
            tsm.deposit_counts(torch.empty((3, 8), dtype=torch.int32, **m),
                               torch.empty((3, 8), dtype=torch.int32, **m),
                               4, 4)
        elif call == "edt_batched":
            tedt.edt2d(torch.empty((3, 4, 4), dtype=torch.bool, **m), 25, 5)
        else:
            # B6 takes one shared scan; per-particle scans are B4's
            scan = (3, 8) if call == "gn_batch_per_particle" else (8,)
            tgb.solve_window_sq(
                torch.empty((3, 4, 4), dtype=torch.int8, **m),
                torch.empty((3, 2), dtype=torch.int32, **m),
                torch.empty((3, 4), dtype=torch.float32, **m),
                torch.empty((*scan, 2), dtype=torch.float32, **m),
                torch.empty(scan, dtype=torch.bool, **m), max_dist=0.5,
                res=0.1, scale=10.0, cell_offset=0, cauchy_c=0.15,
                eps1=1e-4, eps2=1e-4, max_iter=5)


# ---------------------------------------------------------------------------
# geometry, lie, raycast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res", [0.05, 0.1, 0.03])
def test_w2m_bit_exact(res):
    rng = np.random.default_rng(1)
    world = rng.uniform(-40, 40, (5000, 2)).astype(np.float32)
    # exact half-cell and integer-cell positions (the rounding rules)
    k = rng.integers(-400, 400, (500, 2))
    world[:500] = ((k + 0.5) * res).astype(np.float32)
    world[500:1000] = (k * res).astype(np.float32)
    jg, tg = jgeo.MapGeometry(res, 4), tgeo.MapGeometry(res, 4)
    np.testing.assert_array_equal(N(tg.w2m(T(world))),
                                  np.asarray(jg.w2m(jnp.asarray(world))))
    mi_j, mu_j = jg.w2m_frac(jnp.asarray(world))
    mi_t, mu_t = tg.w2m_frac(T(world))
    np.testing.assert_array_equal(N(mi_t), np.asarray(mi_j))
    np.testing.assert_array_equal(N(mu_t), np.asarray(mu_j))


def test_geometry_helpers_bit_exact():
    rng = np.random.default_rng(8)
    jg, tg = jgeo.MapGeometry(0.05, 5), tgeo.MapGeometry(0.05, 5)
    off = jg.cell_offset
    cells = rng.integers(off - 9000, off + 9000, (2000, 2)).astype(np.int32)
    for name in ("m2patch", "m2p", "m2local", "m2w"):
        np.testing.assert_array_equal(
            N(getattr(tg, name)(T(cells))),
            np.asarray(getattr(jg, name)(jnp.asarray(cells))), err_msg=name)
    keys = np.asarray(jg.m2p(jnp.asarray(cells)))
    np.testing.assert_array_equal(N(tg.p2anchor(T(keys))),
                                  np.asarray(jg.p2anchor(jnp.asarray(keys))))


SIZES = ("window_patches", "window_cells", "ray_steps",
         "resident_margin_cells", "resident_window_patches",
         "resident_window_cells", "match_window_cells",
         "resident_update_cells")


@pytest.mark.parametrize("kw", [
    dict(resolution=0.05, max_range=10.0, capacity=8192),      # bench.py
    dict(resolution=0.1, patch_size=16, max_range=8.0),       # the tests
    dict(resolution=0.03, max_range=6.0, l2_max=0.4, truncated_range=5.0,
         resident_extra_patches=1),
])
def test_mapping_config_sizes_match(kw):
    jc = JOptions(**kw).mapping_config()
    tc = tslam.Slam2DOptions(**kw).mapping_config()
    for name in SIZES:
        assert getattr(tc, name) == getattr(jc, name), name
    jd, td = jc.distance, tc.distance
    assert (td.max_sqdist, td.radius_cells, td.max_dist) == (
        jd.max_sqdist, jd.radius_cells, jd.max_dist)
    assert str(td.sq_dtype).split(".")[-1] == np.dtype(jd.sq_dtype).name


def test_lie_se2_matches():
    rng = np.random.default_rng(2)
    n = 2000
    xi = np.concatenate([rng.normal(0, 0.5, (n, 2)),
                         rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    xi[:200, 2] = rng.normal(0, 1e-5, 200)       # small-angle branch
    xi = xi.astype(np.float32)
    pts = rng.normal(0, 5, (n, 2)).astype(np.float32)
    ga, gb = jlie.se2_exp(jnp.asarray(xi)), tlie.se2_exp(T(xi))
    np.testing.assert_allclose(N(gb), np.asarray(ga), atol=1e-6)
    g = np.asarray(ga)
    h = np.roll(g, 1, 0)
    pairs = [
        (jlie.se2_compose(g, h), tlie.se2_compose(T(g), T(h))),
        (jlie.se2_inverse(g), tlie.se2_inverse(T(g))),
        (jlie.se2_apply(g, pts), tlie.se2_apply(T(g), T(pts))),
        (jlie.se2_log(g), tlie.se2_log(T(g))),
        (jlie.se2_angle(g), tlie.se2_angle(T(g))),
        (jlie.se2(*xi.T), tlie.se2(*T(xi).T)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(N(b), np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("max_steps", [12, 82, 202])
def test_ray_cells_bit_exact(max_steps):
    rng = np.random.default_rng(max_steps)
    b = 600
    start = rng.integers(1000, 1200, (b, 2)).astype(np.int32)
    end = start + rng.integers(-max_steps, max_steps + 1, (b, 2)).astype(
        np.int32)
    end[:20] = start[:20]                    # zero-length rays
    end[20:40, 0] = start[20:40, 0]          # axis-aligned
    cj, mj = jray.ray_cells(jnp.asarray(start), jnp.asarray(end), max_steps)
    ct, mt = tray.ray_cells(T(start), T(end), max_steps)
    np.testing.assert_array_equal(N(mt), np.asarray(mj))
    np.testing.assert_array_equal(N(ct), np.asarray(cj))


# ---------------------------------------------------------------------------
# B1: deposit
# ---------------------------------------------------------------------------

H, W = 64, 128


def _deposit_case(case):
    rng = np.random.default_rng(7)
    if case == "sector_ordered":
        nb, t = 40, 128
        ang = np.linspace(0, np.pi / 3, nb)
        rad = rng.uniform(0, 50, (nb, t))
        ly = (32 + rad * np.sin(ang)[:, None]).astype(np.int32).reshape(-1)
        lx = (rad * np.cos(ang)[:, None]).astype(np.int32).reshape(-1)
        ly = np.where(rng.uniform(size=ly.shape) < 0.2, H, ly)
        return ly, lx, 56
    if case == "out_of_band":
        ly = rng.integers(0, H, 5000).astype(np.int32)
        lx = rng.integers(0, W, 5000).astype(np.int32)
        return ly, lx, 16
    if case == "duplicates":
        return (np.full(4100, 3, np.int32), np.full(4100, 7, np.int32), 16)
    if case == "sentinels":
        ly = rng.integers(0, H, 5000).astype(np.int32)
        lx = rng.integers(0, W, 5000).astype(np.int32)
        return np.where(rng.uniform(size=5000) < 0.3, H, ly), lx, 0
    # out_of_range: negative and past-edge indices on both axes
    ly = rng.integers(-5, H + 5, 5000).astype(np.int32)
    lx = rng.integers(-5, W + 5, 5000).astype(np.int32)
    return ly, lx, 24


@pytest.mark.parametrize("impl", ["interpret_i8", "xla"])
@pytest.mark.parametrize("case", ["sector_ordered", "out_of_band",
                                  "duplicates", "sentinels", "out_of_range"])
def test_deposit_bit_exact(case, impl):
    ly, lx, band = _deposit_case(case)
    want = jsm.scatter_counts_2d(jnp.asarray(ly), jnp.asarray(lx), H, W,
                                 impl=impl, band=band)
    got = tsm.deposit_counts(T(ly), T(lx), H, W)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(N(got), np.asarray(want))


# ---------------------------------------------------------------------------
# B2: select4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,dtype", [("interpret", "int8"),
                                        ("jnp", "int8"), ("jnp", "uint8")])
def test_select4_bit_exact(impl, dtype):
    rng = np.random.default_rng(3)
    h, w = 48, 64
    hi = 101 if dtype == "int8" else 256
    grid = rng.integers(0, hi, (h, w)).astype(dtype)
    ly = rng.integers(-3, h + 3, 300).astype(np.int32)
    lx = rng.integers(-3, w + 3, 300).astype(np.int32)
    want = js4.select4_sq(jnp.asarray(grid), jnp.asarray(ly), jnp.asarray(lx),
                          impl=impl)
    got = ts4.select4_sq(T(grid), T(ly), T(lx))
    np.testing.assert_array_equal(N(got), np.asarray(want))


@pytest.mark.parametrize("layout", ["pair_columns", "wide_columns"])
def test_select4_takes_strided_views(layout):
    """Indices as the callers pass them — the columns of a [B, 2] cell
    tensor (lx, ly), or of a wider one — give what contiguous indices give,
    and what the JAX kernel gives."""
    rng = np.random.default_rng(4)
    h, w = 37, 51
    grid = T(rng.integers(0, 101, (h, w)).astype(np.int8))
    ly = rng.integers(-3, h + 3, 300).astype(np.int32)
    lx = rng.integers(-3, w + 3, 300).astype(np.int32)
    if layout == "pair_columns":
        loc = T(np.stack([lx, ly], -1))
        vy, vx = loc[:, 1], loc[:, 0]
    else:
        loc = T(np.stack([ly, ly, lx], -1))
        vy, vx = loc[:, 0], loc[:, 2]
    assert not vy.is_contiguous() and not vx.is_contiguous()
    got = ts4.select4_sq(grid, vy, vx)
    assert torch.equal(got, ts4.select4_sq(grid, T(ly), T(lx)))
    want = js4.select4_sq(jnp.asarray(N(grid)), jnp.asarray(ly),
                          jnp.asarray(lx), impl="interpret")
    np.testing.assert_array_equal(N(got), np.asarray(want))


# ---------------------------------------------------------------------------
# B3: EDT
# ---------------------------------------------------------------------------

def _edt_pallas_interpret(obst, cap, r):
    from jax.experimental import pallas as pl
    vert = pl.pallas_call(
        functools.partial(jedt._vertical_kernel, radius=r),
        out_shape=jax.ShapeDtypeStruct(obst.shape, jnp.int32),
        interpret=True)
    horiz = pl.pallas_call(
        functools.partial(jedt._horizontal_kernel, max_sqdist=cap, radius=r),
        out_shape=jax.ShapeDtypeStruct(obst.shape, jnp.int32),
        interpret=True)
    return np.asarray(horiz(vert(obst)))


@pytest.mark.parametrize("cap,r", [(100, 10), (25, 5)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_edt_bit_exact(density, cap, r):
    rng = np.random.default_rng(int(density * 100) + r)
    obst = rng.random((72, 96)) < density
    got = N(tedt.edt2d(T(obst), cap, r))
    np.testing.assert_array_equal(
        got, np.asarray(jdist.edt2d(jnp.asarray(obst), cap, r)))
    np.testing.assert_array_equal(
        got, _edt_pallas_interpret(jnp.asarray(obst), cap, r))
    assert N(tdist.edt2d(T(obst), cap, r)).tobytes() == got.tobytes()


def _edt_edge_mask(rng, lead, shape, border_only):
    """A mask with obstacles only on the border rows and columns, or ~3%
    random obstacles."""
    if not border_only:
        return rng.random((*lead, *shape)) < 0.03
    m = np.zeros((*lead, *shape), bool)
    m[..., 0, :] = rng.random((*lead, shape[1])) < 0.3
    m[..., -1, :] = rng.random((*lead, shape[1])) < 0.3
    m[..., :, 0] = rng.random((*lead, shape[0])) < 0.3
    m[..., :, -1] = rng.random((*lead, shape[0])) < 0.3
    return m


@pytest.mark.parametrize("border_only", [False, True])
@pytest.mark.parametrize("shape,r", [((61, 203), 10), ((61, 203), 1),
                                     ((33, 65), 5)])
def test_edt_plain_at_ragged_shapes(shape, r, border_only):
    """The plain version at shapes that are no multiple of the kernel's
    32 x 64 tile: one grid against the Pallas kernels in interpret mode,
    three against the vmapped reference."""
    rng = np.random.default_rng(r + 10 * border_only)
    cap = (r + 1) ** 2 - 1
    one = _edt_edge_mask(rng, (), shape, border_only)
    np.testing.assert_array_equal(
        N(tedt.edt2d_plain(T(one), cap, r)),
        _edt_pallas_interpret(jnp.asarray(one), cap, r))
    three = _edt_edge_mask(rng, (3,), shape, border_only)
    want = jax.vmap(lambda m: jdist.edt2d(m, cap, r))(jnp.asarray(three))
    np.testing.assert_array_equal(N(tedt.edt2d_plain(T(three), cap, r)),
                                  np.asarray(want))


@pytest.mark.parametrize("r,match", [(65, "beyond 64"), (255, "uint8"),
                                     (-1, "radius >= 0")])
def test_edt_refuses_radius(r, match):
    """Only a negative radius is refused, on every device. The radii the
    shared-memory tile does not take — beyond its 64-cell halo, and R + 1 =
    256 past its uint8 |dy| — are served, equal to the JAX package's
    ``distance.edt2d`` (on a grid large enough for the JAX shifts: H above
    the largest doubling shift, W above R)."""
    if r < 0:
        with pytest.raises(ValueError, match=match):
            tedt.edt2d(torch.zeros((8, 8), dtype=torch.bool), 25, r)
        return
    rng = np.random.default_rng(r)
    shape = (140, 300) if r > 128 else (70, 90)
    obst = rng.random(shape) < 0.002
    obst[0, rng.integers(0, shape[1], 3)] = True
    cap = min((r + 1) ** 2 - 1, 32767)
    want = jax.jit(jdist.edt2d, static_argnums=(1, 2))(jnp.asarray(obst),
                                                       cap, r)
    np.testing.assert_array_equal(N(tedt.edt2d(T(obst), cap, r)),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# pool and windows
# ---------------------------------------------------------------------------

TABLE = ("keys", "slots", "free_slots", "n_free", "overflow")


def _table_equal(tt, jt):
    for f in TABLE:
        np.testing.assert_array_equal(N(getattr(tt, f)),
                                      np.asarray(getattr(jt, f)), err_msg=f)


def _keys(rng, n):
    px = rng.integers(16300, 16460, n)
    py = rng.integers(16300, 16460, n)
    keys = np.unique((px << 15) | py).astype(np.int32)
    return rng.permutation(keys)


@pytest.mark.parametrize("capacity,batch,rounds", [(256, 40, 4), (64, 40, 3),
                                                   (16, 30, 2)])
def test_pool_insert_lookup_bit_exact(capacity, batch, rounds):
    """Batches of unique keys (with skipped negatives) inserted until the
    pool overflows; every table field and returned slot bit-equal."""
    rng = np.random.default_rng(capacity)
    jt, tt = jpool.table_init(capacity), tpool.table_init(capacity)
    _table_equal(tt, jt)
    seen = np.zeros(0, np.int32)
    for _ in range(rounds):
        keys = _keys(rng, batch)
        # re-insert some keys already present, skip some entries
        keys[: batch // 5] = rng.choice(seen, batch // 5) if seen.size else -1
        keys = np.unique(keys)
        keys = rng.permutation(np.concatenate([keys, [-1, -1]])).astype(
            np.int32)
        jt, js = jpool.table_insert_unique(jt, jnp.asarray(keys))
        tt, ts = tpool.table_insert_unique(tt, T(keys))
        np.testing.assert_array_equal(N(ts), np.asarray(js))
        _table_equal(tt, jt)
        seen = np.unique(np.concatenate([seen, keys[keys >= 0]]))
    probe = np.concatenate([seen, _keys(rng, 50)]).astype(np.int32)
    np.testing.assert_array_equal(
        N(tpool.table_lookup(tt, T(probe))),
        np.asarray(jpool.table_lookup(jt, jnp.asarray(probe))))
    if capacity == 16:
        assert int(tt.overflow) > 0


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_gather_scatter_window_bit_exact(dtype):
    rng = np.random.default_rng(5)
    length, cap = 4, 64
    jg = jgeo.MapGeometry(0.1, 2)
    tg = tgeo.MapGeometry(0.1, 2)
    org = np.array([jg.cell_offset + 8, jg.cell_offset - 12], np.int32)
    wp = 5
    keys_j = jwin.window_patch_keys(jg, jnp.asarray(org), wp)
    keys_t = twin.window_patch_keys(tg, T(org), wp)
    np.testing.assert_array_equal(N(keys_t), np.asarray(keys_j))
    # half the window's patches exist in the pool
    some = np.asarray(keys_j).reshape(-1)[rng.random(wp * wp) < 0.5]
    jt, _ = jpool.table_insert_unique(jpool.table_init(cap),
                                      jnp.asarray(some))
    tt, _ = tpool.table_insert_unique(tpool.table_init(cap), T(some))
    arr = (rng.random((cap + 1, length, length)) * 50).astype(dtype)
    default = 7
    gj, sj = jwin.gather_window(jt, jnp.asarray(arr), keys_j, default)
    gt, st = twin.gather_window(tt, T(arr), keys_t, default)
    np.testing.assert_array_equal(N(st), np.asarray(sj))
    np.testing.assert_array_equal(N(gt), np.asarray(gj))
    new = (rng.random((wp * length, wp * length)) * 50).astype(dtype)
    mask = rng.random(new.shape) < 0.02
    for wm in (None, mask):
        aj = jwin.scatter_window(jnp.asarray(arr), sj, jnp.asarray(new),
                                 None if wm is None else jnp.asarray(wm))
        at = twin.scatter_window(T(arr).clone(), st, T(new),
                                 None if wm is None else T(wm))
        np.testing.assert_array_equal(N(at), np.asarray(aj))


# ---------------------------------------------------------------------------
# interpolation and the IRLS solve
# ---------------------------------------------------------------------------

def _match_problem(seed=4, res=0.05, n_beams=360):
    """A squared-distance window built from one simulated scan (its hits
    are the obstacles), the next scan's points and a perturbed pose."""
    sim = jsim.simulate(jsim.SimConfig(
        n_steps=40, seed=seed, laser=jsim.LaserSpec(n_beams=n_beams,
                                                    max_range=8.0)))
    geo = jgeo.MapGeometry(res, 5)
    dcfg = jdist.DistanceConfig(geo, 0.5)
    w = 256
    gt = sim.poses_gt[10]
    center = geo.np_w2m(gt[:2])
    org = (center - w // 2).astype(np.int32)
    mask = np.zeros((w, w), bool)
    for k in (8, 10, 12):
        p = sim.poses_gt[k]
        pts = sim.clouds[k].points[:, :2]
        c, s = np.cos(p[2]), np.sin(p[2])
        world = np.stack([p[0] + c * pts[:, 0] - s * pts[:, 1],
                          p[1] + s * pts[:, 0] + c * pts[:, 1]], -1)
        loc = geo.np_w2m(world) - org
        ok = np.all((loc >= 0) & (loc < w), -1)
        mask[loc[ok, 1], loc[ok, 0]] = True
    grid = np.asarray(jdist.edt2d(jnp.asarray(mask), dcfg.max_sqdist,
                                  dcfg.radius_cells)).astype(np.int8)
    pts = np.zeros((n_beams, 2), np.float32)
    p = sim.clouds[11].points[:, :2].astype(np.float32)
    pts[:len(p)] = p
    msk = np.arange(n_beams) < len(p)
    g = sim.poses_gt[11]
    pose0 = np.array([g[0] + 0.04, g[1] - 0.03, np.cos(g[2] + 0.02),
                      np.sin(g[2] + 0.02)], np.float32)
    return geo, dcfg, grid, org, pts, msk, pose0


def test_interp_window_sq_within_one_ulp():
    geo, dcfg, grid, org, pts, msk, pose0 = _match_problem()
    rng = np.random.default_rng(9)
    world = np.asarray(jgeo.MapGeometry(geo.resolution, 5).m2w(
        jnp.asarray(org))) + rng.uniform(-1, 14, (4000, 2))
    world = world.astype(np.float32)
    tg = tgeo.MapGeometry(geo.resolution, 5)
    dj, gj = jdist._interp_window_sq(jnp.asarray(grid), jnp.asarray(org), geo,
                                     jnp.asarray(world), dcfg.max_dist)
    dt, gt = tdist._interp_window_sq(T(grid), T(org), tg, T(world),
                                     dcfg.max_dist)
    np.testing.assert_array_max_ulp(N(dt), np.asarray(dj), maxulp=1)
    np.testing.assert_array_max_ulp(N(gt), np.asarray(gj), maxulp=1)


@pytest.mark.parametrize("strategy", ["gn", "lm"])
def test_solve_window_matches(strategy):
    geo, dcfg, grid, org, pts, msk, pose0 = _match_problem()
    tg = tgeo.MapGeometry(geo.resolution, 5)
    jo = jsolver.SolverOptions(max_iterations=50, strategy=strategy,
                               robust=jrobust.CAUCHY_SCAN)
    to = tsolver.SolverOptions(max_iterations=50, strategy=strategy,
                               robust=trobust.CAUCHY_SCAN)
    rj = jax.jit(lambda g, o, p, m, s: jmatch.solve_window(
        g, o, geo, dcfg.max_dist, p, m, s, jo))(
        jnp.asarray(grid), jnp.asarray(org), jnp.asarray(pts),
        jnp.asarray(msk), jnp.asarray(pose0))
    rt = tmatch.solve_window(T(grid), T(org), tg, dcfg.max_dist, T(pts),
                             T(msk), T(pose0), to)
    assert int(rt.iterations) == int(rj.iterations) > 1
    np.testing.assert_allclose(N(rt.state), np.asarray(rj.state), atol=1e-5)
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-4)
