"""The port's standalone occupancy states (iris_lama_tpu_torch/sdm/
occupancy.py) against the JAX package's, on the CPU.

The seven cases of tests/test_occupancy.py run on the port, each state
also held against the JAX package's for the same calls: tables and cell
arrays equal (log-odds within 1e-6: XLA's CPU code may fuse ``lo +
h*HIT``). Then random scans with duplicate cells through both, and the
frequency counts' uint16 wrap at 65535.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.sdm import occupancy as jocc
from iris_lama_tpu.sdm.geometry import MapGeometry as JGeo

from iris_lama_tpu_torch.sdm import occupancy as occ
from iris_lama_tpu_torch.sdm import pool as pool_mod
from iris_lama_tpu_torch.sdm.geometry import MapGeometry

GEO = MapGeometry(resolution=0.1, log2dim=4)
JGEO = JGeo(resolution=0.1, log2dim=4)
CFG = occ.OccupancyConfig(GEO, 64)
JCFG = jocc.OccupancyConfig(JGEO, 64)
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


def cells_of(points):
    return GEO.w2m(torch.as_tensor(np.asarray(points, np.float32)))


def jcells_of(points):
    return JGEO.w2m(jnp.asarray(np.asarray(points, np.float32)))


def t(a):
    return torch.as_tensor(np.asarray(a))


def assert_same(port, ref, atol=0.0):
    """A port state equal to a JAX state: table and cell arrays."""
    for f in TABLE:
        np.testing.assert_array_equal(getattr(port.table, f).numpy(),
                                      np.asarray(getattr(ref.table, f)), f)
    for name, a in zip(port._fields[1:], port[1:]):
        b = np.asarray(getattr(ref, name))
        if atol:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b, name)


def test_simple_set_and_query():
    state = occ.simple_init(CFG)
    jstate = jocc.simple_init(JCFG)
    for pts, v in (([[0.0, 0.0], [1.0, 1.0]], -1), ([[2.0, 2.0]], 1)):
        state = occ.simple_set(state, GEO, cells_of(pts), v)
        jstate = jocc.simple_set(jstate, JGEO, jcells_of(pts), v)
    assert_same(state, jstate)
    assert bool(occ.simple_is_free(state, GEO, cells_of([[0.0, 0.0]]))[0])
    assert bool(occ.simple_is_occupied(state, GEO,
                                       cells_of([[2.0, 2.0]]))[0])
    assert bool(occ.simple_is_unknown(state, GEO, cells_of([[5.0, 5.0]]))[0])
    # unknown for unallocated patches too (const get -> null, map.cpp:414)
    assert not bool(occ.simple_is_free(state, GEO, cells_of([[9.0, 9.0]]))[0])
    # a masked set sends the unmasked cells to the trash slot
    c = cells_of([[3.0, 3.0], [4.0, 4.0]])
    m = torch.tensor([True, False])
    state = occ.simple_set(state, GEO, c, 1, mask=m)
    jstate = jocc.simple_set(jstate, JGEO, jcells_of([[3.0, 3.0],
                                                      [4.0, 4.0]]), 1,
                             mask=jnp.asarray([True, False]))
    assert_same(state, jstate)


def _freq_pair(pts, occ_add, vis_add, state=None, jstate=None):
    state = occ.frequency_init(CFG) if state is None else state
    jstate = jocc.frequency_init(JCFG) if jstate is None else jstate
    state = occ.frequency_apply_counts(state, GEO, cells_of(pts), t(occ_add),
                                       t(vis_add))
    jstate = jocc.frequency_apply_counts(jstate, JGEO, jcells_of(pts),
                                         jnp.asarray(occ_add),
                                         jnp.asarray(vis_add))
    assert_same(state, jstate)
    return state, jstate


def test_frequency_counts_and_threshold():
    c = cells_of([[1.0, 1.0]])
    # 1 hit -> occupied (1/1 > 0.25)
    state, jstate = _freq_pair([[1.0, 1.0]], [1], [1])
    assert bool(occ.frequency_is_occupied(state, GEO, c)[0])
    # +4 free visits -> 1/5 < 0.25 -> free
    state, _ = _freq_pair([[1.0, 1.0]], [0], [4], state, jstate)
    assert bool(occ.frequency_is_free(state, GEO, c)[0])
    np.testing.assert_allclose(float(occ.frequency_prob(state, GEO, c)[0]),
                               1.0 / 5.0)
    # boundary: occ/vis == 0.25 exactly -> neither free nor occupied
    state2, _ = _freq_pair([[1.0, 1.0]], [1], [4])
    assert not bool(occ.frequency_is_occupied(state2, GEO, c)[0])
    assert not bool(occ.frequency_is_free(state2, GEO, c)[0])


def test_frequency_prune():
    state, jstate = _freq_pair([[1.0, 1.0], [2.0, 2.0]], [1, 2], [1, 2])
    state = occ.frequency_prune(state)
    assert_same(state, jocc.frequency_prune(jstate))
    # single-visit cell dropped; double-visit kept
    assert bool(occ.frequency_is_unknown(state, GEO,
                                         cells_of([[1.0, 1.0]]))[0])
    assert bool(occ.frequency_is_occupied(state, GEO,
                                          cells_of([[2.0, 2.0]]))[0])


def _prob_pair(pts, hits, misses, state=None, jstate=None):
    state = occ.probabilistic_init(CFG) if state is None else state
    jstate = jocc.probabilistic_init(JCFG) if jstate is None else jstate
    state = occ.probabilistic_apply(state, GEO, cells_of(pts), t(hits),
                                    t(misses))
    jstate = jocc.probabilistic_apply(jstate, JGEO, jcells_of(pts),
                                      jnp.asarray(hits), jnp.asarray(misses))
    assert_same(state, jstate, atol=1e-6)
    return state, jstate


def test_probabilistic_logodds():
    c = cells_of([[1.0, 1.0]])
    state, jstate = _prob_pair([[1.0, 1.0]], [1], [0])
    # one hit: logodds = log(0.7/0.3) -> prob 0.7
    np.testing.assert_allclose(float(occ.probabilistic_prob(state, GEO, c)[0]),
                               0.7, atol=1e-5)
    assert bool(occ.probabilistic_is_occupied(state, GEO, c)[0])
    # many misses clamp at logodds(0.12)
    state, _ = _prob_pair([[1.0, 1.0]], [0], [50], state, jstate)
    np.testing.assert_allclose(float(occ.probabilistic_prob(state, GEO, c)[0]),
                               0.12, atol=1e-5)
    assert bool(occ.probabilistic_is_free(state, GEO, c)[0])


def _seq_per_visit(lo0, hits, misses):
    """Sequential per-visit oracle (probabilistic_occupancy_map.cpp:82-107),
    canonical order: all hits then all misses (see probabilistic_saturate)."""
    lo = float(lo0)
    for _ in range(int(hits)):
        lo = min(lo + occ.PROB_HIT, occ.PROB_CLAMP_MAX)
    for _ in range(int(misses)):
        lo = max(lo + occ.PROB_MISS, occ.PROB_CLAMP_MIN)
    return lo


def test_probabilistic_per_visit_clamp_oracle():
    """Saturating closed form == per-visit sequential clamping, including
    saturated cells receiving mixed evidence over many scans; the JAX
    package's closed form within 1e-6 on the same inputs."""
    r = np.random.default_rng(7)
    lo = np.zeros(64, np.float32)
    for _ in range(40):
        hits = r.integers(0, 8, size=64)
        misses = r.integers(0, 8, size=64)
        got = occ.probabilistic_saturate(t(lo), t(hits), t(misses)).numpy()
        want = np.array([_seq_per_visit(lo[i], hits[i], misses[i])
                         for i in range(64)], np.float32)
        np.testing.assert_allclose(got, want, atol=1e-5)
        ref = np.asarray(jocc.probabilistic_saturate(
            jnp.asarray(lo), jnp.asarray(hits), jnp.asarray(misses)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        lo = got


def test_probabilistic_saturated_mixed_desaturates():
    """A cell pinned at clamp_max that receives 1 hit + 1 miss in one scan
    lands below clamp_max (the per-visit clamp absorbs the hit)."""
    lo = torch.tensor([occ.PROB_CLAMP_MAX], dtype=torch.float32)
    got = float(occ.probabilistic_saturate(lo, torch.tensor([1]),
                                           torch.tensor([1]))[0])
    np.testing.assert_allclose(got, occ.PROB_CLAMP_MAX + occ.PROB_MISS,
                               atol=1e-6)


def test_probabilistic_apply_duplicate_cells():
    """Duplicate cells in one apply() accumulate counts before saturating."""
    state, _ = _prob_pair([[1.0, 1.0], [1.0, 1.0]], [1, 2], [0, 1])
    want = _seq_per_visit(0.0, 3, 1)
    one = cells_of([[1.0, 1.0]])
    p = float(occ.probabilistic_prob(state, GEO, one)[0])
    np.testing.assert_allclose(np.log(1.0 / (1.0 / p - 1.0)), want,
                               atol=1e-5)


def _scan_cells(rng, n, spread):
    """n cells of a few patches, duplicates included, as world points."""
    pts = rng.normal(0.0, spread, (n, 2)).astype(np.float32)
    return np.concatenate([pts, pts[: n // 4]])


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_random_scans_match_jax(seed):
    """Scans of 1,000 cells over ~20 patches (duplicates included), three
    in a row, a pool of 16 patches that fills up (overflow and the trash
    slot): both states equal the JAX package's after every scan, and the
    queries agree."""
    rng = np.random.default_rng(seed)
    cfg, jcfg = occ.OccupancyConfig(GEO, 16), jocc.OccupancyConfig(JGEO, 16)
    fs, jfs = occ.frequency_init(cfg), jocc.frequency_init(jcfg)
    ps, jps = occ.probabilistic_init(cfg), jocc.probabilistic_init(jcfg)
    for _ in range(3):
        pts = _scan_cells(rng, 1000, 2.5)
        occ_add = rng.integers(0, 3, len(pts))
        vis_add = occ_add + rng.integers(0, 3, len(pts))
        fs = occ.frequency_apply_counts(fs, GEO, cells_of(pts), t(occ_add),
                                        t(vis_add))
        jfs = jocc.frequency_apply_counts(jfs, JGEO, jcells_of(pts),
                                          jnp.asarray(occ_add),
                                          jnp.asarray(vis_add))
        assert_same(fs, jfs)
        ps = occ.probabilistic_apply(ps, GEO, cells_of(pts), t(occ_add),
                                     t(vis_add - occ_add))
        jps = jocc.probabilistic_apply(jps, JGEO, jcells_of(pts),
                                       jnp.asarray(occ_add),
                                       jnp.asarray(vis_add - occ_add))
        assert_same(ps, jps, atol=1e-6)
    assert int(fs.table.overflow) > 0
    probe = _scan_cells(rng, 500, 3.0)
    c, jc = cells_of(probe), jcells_of(probe)
    for fn in ("frequency_is_free", "frequency_is_occupied",
               "frequency_is_unknown"):
        np.testing.assert_array_equal(getattr(occ, fn)(fs, GEO, c).numpy(),
                                      np.asarray(getattr(jocc, fn)(jfs, JGEO,
                                                                   jc)), fn)
    np.testing.assert_array_equal(occ.frequency_prob(fs, GEO, c).numpy(),
                                  np.asarray(jocc.frequency_prob(jfs, JGEO,
                                                                 jc)))
    for fn in ("probabilistic_is_free", "probabilistic_is_occupied"):
        np.testing.assert_array_equal(getattr(occ, fn)(ps, GEO, c).numpy(),
                                      np.asarray(getattr(jocc, fn)(jps, JGEO,
                                                                   jc)), fn)
    np.testing.assert_allclose(occ.probabilistic_prob(ps, GEO, c).numpy(),
                               np.asarray(jocc.probabilistic_prob(jps, JGEO,
                                                                  jc)),
                               rtol=0, atol=1e-6)


def test_frequency_counts_wrap_at_65535():
    """Counts add mod 2**16 like the JAX package's uint16 scatter: a cell
    at 65,530 visits that gets 10 more holds 4; added counts of 65,536 and
    more are taken mod 2**16 too; the port's int32 state holds the uint16
    values."""
    pts = [[1.0, 1.0], [1.0, 1.0], [2.0, 2.0]]
    state, jstate = _freq_pair(pts, [65530, 0, 70000], [65530, 3, 65535])
    c = cells_of(pts)
    assert state.visited.dtype == torch.int32
    state, jstate = _freq_pair(pts, [3, 4, 1], [5, 5, 1], state, jstate)
    vis = occ.frequency_is_unknown(state, GEO, c)
    _, idx = pool_mod.locate(state.table, GEO, c,
                            state.visited.shape[0] - 1)
    np.testing.assert_array_equal(state.visited[idx].numpy(),
                                  [(65533 + 10) % 65536] * 2 + [0])
    np.testing.assert_array_equal(state.occupied[idx].numpy(),
                                  [(65530 + 7) % 65536] * 2
                                  + [(70000 + 1) % 65536])
    assert bool(vis[2])      # 65535 + 1 visits wrap to 0: unknown again
