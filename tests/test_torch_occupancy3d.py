"""The port's 3D occupancy maps and 3D EDT (iris_lama_tpu_torch/sdm/
occupancy3d.py) and the ordered batch insert (sdm/pool.py) against the
JAX package's, on the CPU.

The four cases of tests/test_occupancy3d.py run on the port, each state
also held against the JAX package's for the same calls: tables, counts,
cells and ``edt3d`` bit-exact, log-odds within 4e-6 (XLA's CPU code may
fuse ``lo + h*HIT`` into an FMA). Then the places where the port could
part from JAX: the 4,096 cap on the unique keys a call allocates, the
ordered insert against the sequential one (fresh, half-full and
overflowing pools), and the uint16 wrap of the frequency counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.sdm import occupancy3d as jo3
from iris_lama_tpu.sdm import pool as jpool
from iris_lama_tpu.sdm.raycast import ray_cells as jray_cells

from iris_lama_tpu_torch.sdm import occupancy3d as o3
from iris_lama_tpu_torch.sdm import pool as pool_mod

GEO = o3.MapGeometry3(resolution=0.1, log2dim=4)
JGEO = jo3.MapGeometry3(resolution=0.1, log2dim=4)
TABLE = ("keys", "slots", "free_slots", "n_free", "overflow")
LO_ATOL = 4e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.as_tensor(np.array(a))


def assert_table(port, ref):
    for f in TABLE:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)


def assert_same(port, ref, atol=0.0):
    """A port state equal to a JAX state: table and cell arrays."""
    assert_table(port.table, ref.table)
    for name, a in zip(port._fields[1:], port[1:]):
        b = np.asarray(getattr(ref, name))
        if atol:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b.astype(
                a.numpy().dtype), name)


def ring_cloud(rng, n):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([2.0 * np.cos(ang), 2.0 * np.sin(ang),
                     rng.uniform(-0.3, 0.3, n)], -1).astype(np.float32)


def test_frequency3_scan_matches_dict_oracle():
    rng = np.random.default_rng(66)
    n = 30
    pts = ring_cloud(rng, n)
    origin = np.zeros(3, np.float32)
    state = o3.frequency3_insert_scan(
        o3.frequency3_init(GEO, 512, device="cpu"), GEO, t(pts),
        torch.ones(n, dtype=torch.bool), t(origin), max_steps=40)
    jstate = jo3.frequency3_insert_scan(
        jo3.frequency3_init(JGEO, 512), JGEO, jnp.asarray(pts),
        jnp.ones(n, bool), jnp.asarray(origin), max_steps=40)
    assert_same(state, jstate)

    # the JAX test's oracle: sequential dict rasterisation (the rays from
    # one batched call of the JAX package's ray walk)
    occ, vis = {}, {}
    start = np.asarray(JGEO.w2m(jnp.asarray(origin)))
    hits = np.asarray(JGEO.w2m(jnp.asarray(pts)))
    rays, rmask = (np.asarray(a) for a in jray_cells(
        np.broadcast_to(start, hits.shape), hits, 40))
    for hit, cells, m in zip(hits, rays, rmask):
        occ[tuple(hit)] = occ.get(tuple(hit), 0) + 1
        vis[tuple(hit)] = vis.get(tuple(hit), 0) + 1
        for c in cells[m]:
            vis[tuple(c)] = vis.get(tuple(c), 0) + 1
    all_cells = t(np.asarray(sorted(vis), np.int32))
    slots, idx = o3.locate3(state.table, GEO, all_cells,
                            state.occupied.shape[0] - 1)
    assert (slots >= 0).all()
    np.testing.assert_array_equal(state.visited[idx].numpy(),
                                  [vis[tuple(c)] for c in all_cells.tolist()])
    np.testing.assert_array_equal(state.occupied[idx].numpy(),
                                  [occ.get(tuple(c), 0)
                                   for c in all_cells.tolist()])
    hit_cells = GEO.w2m(t(pts))
    assert o3.frequency3_is_occupied(state, GEO, hit_cells).all()
    probe = all_cells[::7]
    jprobe = jnp.asarray(probe.numpy())
    np.testing.assert_array_equal(
        o3.frequency3_is_free(state, GEO, probe).numpy(),
        np.asarray(jo3.frequency3_is_free(jstate, JGEO, jprobe)))
    np.testing.assert_array_equal(
        o3.frequency3_is_occupied(state, GEO, probe).numpy(),
        np.asarray(jo3.frequency3_is_occupied(jstate, JGEO, jprobe)))


def test_simple3_and_probabilistic3():
    pts = np.array([[1.0, 2.0, 0.5]], np.float32)
    cells = GEO.w2m(t(pts))
    jcells = JGEO.w2m(jnp.asarray(pts))
    s = o3.simple3_set(o3.simple3_init(GEO, 64, device="cpu"), GEO, cells, 1)
    js = jo3.simple3_set(jo3.simple3_init(JGEO, 64), JGEO, jcells, 1)
    assert_same(s, js)
    assert int(o3.simple3_query(s, GEO, cells)[0]) == 1
    far = GEO.w2m(t([[9.0, 9.0, 9.0]]))
    assert int(o3.simple3_query(s, GEO, far)[0]) == 0

    p = o3.probabilistic3_apply(o3.probabilistic3_init(GEO, 64, device="cpu"),
                                GEO, cells, t([1]), t([0]))
    jp = jo3.probabilistic3_apply(jo3.probabilistic3_init(JGEO, 64), JGEO,
                                  jcells, jnp.asarray([1]), jnp.asarray([0]))
    assert_same(p, jp, atol=LO_ATOL)
    _, idx = o3.locate3(p.table, GEO, cells, p.logodds.shape[0] - 1)
    np.testing.assert_allclose(float(p.logodds[idx][0]), np.log(0.7 / 0.3),
                               atol=1e-5)


def test_random_clouds_all_states_match_jax():
    """Scans with duplicate cells into every 3D state, carried over three
    calls: tables and cells bit-equal, log-odds within 4e-6."""
    rng = np.random.default_rng(3)
    geo, jgeo = o3.MapGeometry3(0.1, 2), jo3.MapGeometry3(0.1, 2)
    f, jf = o3.frequency3_init(geo, 300, "cpu"), jo3.frequency3_init(jgeo,
                                                                      300)
    s, js = o3.simple3_init(geo, 300, "cpu"), jo3.simple3_init(jgeo, 300)
    p, jp = (o3.probabilistic3_init(geo, 300, "cpu"),
             jo3.probabilistic3_init(jgeo, 300))
    for k in range(3):
        pts = rng.uniform(-1.5, 1.5, (60, 3)).astype(np.float32)
        pts[::5] = pts[1::5]                       # duplicate hit cells
        mask = rng.random(60) < 0.8
        org = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
        f = o3.frequency3_insert_scan(f, geo, t(pts), t(mask), t(org), 30)
        jf = jo3.frequency3_insert_scan(jf, jgeo, jnp.asarray(pts),
                                        jnp.asarray(mask), jnp.asarray(org),
                                        30)
        assert_same(f, jf)
        cells = geo.w2m(t(pts))
        jcells = jgeo.w2m(jnp.asarray(pts))
        s = o3.simple3_set(s, geo, cells, k - 1)
        js = jo3.simple3_set(js, jgeo, jcells, k - 1)
        assert_same(s, js)
        np.testing.assert_array_equal(
            o3.simple3_query(s, geo, cells).numpy(),
            np.asarray(jo3.simple3_query(js, jgeo, jcells)))
        hits = rng.integers(0, 3, 60)
        misses = rng.integers(0, 4, 60)
        p = o3.probabilistic3_apply(p, geo, cells, t(hits), t(misses))
        jp = jo3.probabilistic3_apply(jp, jgeo, jcells, jnp.asarray(hits),
                                      jnp.asarray(misses))
        assert_same(p, jp, atol=LO_ATOL)
    assert int(f.table.num_patches()) > 20


def brute3(obst, cap):
    zz, yy, xx = np.nonzero(obst)
    out = np.full(obst.shape, cap, np.int64)
    gz, gy, gx = np.mgrid[0:obst.shape[0], 0:obst.shape[1], 0:obst.shape[2]]
    for z, y, x in zip(zz, yy, xx):
        out = np.minimum(out, (gz - z) ** 2 + (gy - y) ** 2 + (gx - x) ** 2)
    return np.minimum(out, cap)


@pytest.mark.parametrize("density,cap,r", [(0.02, 36, 6), (0.002, 100, 10),
                                           (0.3, 9, 3), (1.0, 16, 4)])
def test_edt3d_exact(density, cap, r):
    obst = np.random.default_rng(66).random((24, 20, 28)) < density
    got = o3.edt3d(t(obst), cap, r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), brute3(obst, cap))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jo3.edt3d(jnp.asarray(obst),
                                                       cap, r)))


def test_edt3d_empty_and_batched():
    obst = np.zeros((8, 8, 8), bool)
    got = o3.edt3d(t(obst), 25, 5)
    np.testing.assert_array_equal(got.numpy(), 25)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jo3.edt3d(jnp.asarray(obst), 25, 5)))
    # a leading batch axis gives each grid's own transform
    rng = np.random.default_rng(8)
    batch = rng.random((3, 12, 10, 14)) < 0.01
    got = o3.edt3d(t(batch), 49, 7).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], brute3(batch[i], 49))


# ---------------------------------------------------------------------------
# Where the port could part from JAX
# ---------------------------------------------------------------------------

def test_unique_key_cap_4096():
    """More than 4,096 unique patch keys in one call: the 4,096 smallest
    are allocated, the rest never are (their cells land on the trash
    slot and are cleared), as in the JAX package."""
    geo, jgeo = o3.MapGeometry3(0.1, 0), jo3.MapGeometry3(0.1, 0)
    rng = np.random.default_rng(11)
    pts = rng.uniform(-3, 3, (5000, 3)).astype(np.float32)
    pts[:100] = pts[100:200]
    mask = np.ones(5000, bool)
    org = np.zeros(3, np.float32)
    f = o3.frequency3_insert_scan(o3.frequency3_init(geo, 8192, "cpu"), geo,
                                  t(pts), t(mask), t(org), 1)
    jf = jo3.frequency3_insert_scan(jo3.frequency3_init(jgeo, 8192), jgeo,
                                    jnp.asarray(pts), jnp.asarray(mask),
                                    jnp.asarray(org), 1)
    n_unique = len(np.unique(geo.m2p(geo.w2m(t(pts))).numpy()))
    assert n_unique > 4096
    assert int(f.table.num_patches()) == 4096
    assert_same(f, jf)
    s = o3.simple3_set(o3.simple3_init(geo, 8192, "cpu"), geo,
                       geo.w2m(t(pts)), 1)
    js = jo3.simple3_set(jo3.simple3_init(jgeo, 8192), jgeo,
                         jgeo.w2m(jnp.asarray(pts)), 1)
    assert_same(s, js)


def _seq_vs_ordered(table, jtable, keys):
    """The port's ordered insert, its sequential insert and JAX's
    sequential insert of ``keys``: all three tables and slot lists
    equal."""
    a, sa = pool_mod.table_insert_ordered(table, t(keys))
    b, sb = pool_mod.table_insert(table, t(keys))
    jt, js = jpool.table_insert(jtable, jnp.asarray(keys))
    assert_table(a, jt)
    assert_table(b, jt)
    np.testing.assert_array_equal(sa.numpy(), np.asarray(js))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(js))
    return a, jt


@pytest.mark.parametrize("case", ["fresh", "half_full", "overflow"])
def test_ordered_insert_equals_sequential(case):
    rng = np.random.default_rng({"fresh": 1, "half_full": 2,
                                 "overflow": 3}[case])
    cap = 256
    table, jtable = pool_mod.table_init(cap), jpool.table_init(cap)
    if case != "fresh":
        pre = np.unique(rng.integers(0, 1 << 29, 128)).astype(np.int32)
        table, jtable = _seq_vs_ordered(table, jtable, pre)
        table, _ = pool_mod.table_remove(table, t(pre[::4]))
        jtable, _ = jpool.table_remove(jtable, jnp.asarray(pre[::4]))
        assert_table(table, jtable)
    n = {"fresh": 200, "half_full": 120, "overflow": 400}[case]
    keys = np.unique(rng.integers(0, 1 << 29, n)).astype(np.int32)
    # sorted (as the 3D maps insert), with a fill value and present keys
    keys = np.concatenate([[-1], keys]).astype(np.int32)
    table, jtable = _seq_vs_ordered(table, jtable, keys)
    if case == "overflow":
        assert int(table.overflow) > 0 and int(table.n_free) == 0
    # unsorted keys (the .smd readers insert in file order)
    more = rng.permutation(np.unique(rng.integers(0, 1 << 29, 60)))
    _seq_vs_ordered(table, jtable, more.astype(np.int32))


def test_claim_round_insert_is_not_sequential():
    """Why the 3D maps do not use ``table_insert_unique``: with entry e
    taken, key a (base e) goes to e + 1 in the sequential insert and key
    b > a (base e + 1) to e + 2; the claim rounds give b entry e + 1 in
    the first round and a entry e + 2. Lookups agree, the hash arrays
    (which the JAX package's 3D maps fix by its sequential insert) do
    not."""
    table = pool_mod.table_init(16)
    hsize = table.table_size
    h = pool_mod._hash(torch.arange(1 << 12, dtype=torch.int32),
                       hsize).tolist()
    e = h[0]
    a = next(k for k in range(1, 1 << 12) if h[k] == e)
    b = next(k for k in range(a + 1, 1 << 12) if h[k] == (e + 1) % hsize)
    table, _ = pool_mod.table_insert(table, t([0]))
    keys = t(np.array([a, b], np.int32))
    seq, s_seq = pool_mod.table_insert(table, keys)
    ordr, s_ord = pool_mod.table_insert_ordered(table, keys)
    claim, _ = pool_mod.table_insert_unique(table, keys)
    assert torch.equal(seq.keys, ordr.keys) and torch.equal(s_seq, s_ord)
    for tab in (seq, ordr, claim):
        np.testing.assert_array_equal(
            pool_mod.table_lookup(tab, keys).numpy(), s_seq.numpy())
    assert not torch.equal(seq.keys, claim.keys)


def test_frequency3_counts_wrap_at_uint16():
    """One cell hit 70,000 times in one call and 70,000 more in the
    next: the counts wrap mod 2**16 as JAX's uint16 scatter-add does."""
    n = 70_000
    pts = np.tile(np.array([[0.5, 0.5, 0.5]], np.float32), (n, 1))
    mask = np.ones(n, bool)
    org = np.array([0.45, 0.5, 0.5], np.float32)
    f = o3.frequency3_init(GEO, 8, "cpu")
    jf = jo3.frequency3_init(JGEO, 8)
    for _ in range(2):
        f = o3.frequency3_insert_scan(f, GEO, t(pts), t(mask), t(org), 2)
        jf = jo3.frequency3_insert_scan(jf, JGEO, jnp.asarray(pts),
                                        jnp.asarray(mask), jnp.asarray(org),
                                        2)
        assert_same(f, jf)
    _, idx = o3.locate3(f.table, GEO, GEO.w2m(t(pts[:1])),
                        f.occupied.shape[0] - 1)
    assert int(f.occupied[idx][0]) == (2 * n) % 65536
    assert int(f.occupied.max()) < 65536
