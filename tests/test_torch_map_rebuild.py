"""The port's map rebuild (parallel/map_rebuild.py) against the JAX
package's, on the CPU, on tests/test_map_rebuild.py's scans and config: on
one device, and split over 3 and 4 gloo ranks (spawned processes) against
the JAX package's 8-device sharded rebuild.

Tolerances: none — grid bounds, counts, squared distances, meters, the
packed pool (table, slots, cell arrays) are bit-equal; against the port's
own sequential update_maps, counts are equal and stored distances within
1e-6 (test_rebuild_matches_sequential_update_maps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from iris_lama_tpu.algos.slam2d import Slam2DOptions as JOptions
from iris_lama_tpu.parallel import map_rebuild as jreb
from iris_lama_tpu.sdm import distance as jdist
from iris_lama_tpu.utils import simulator
from iris_lama_tpu.utils.cloud import pad_scan

import torch_parallel_ranks as ranks
from iris_lama_tpu_torch.algos.slam2d import Slam2DOptions
from iris_lama_tpu_torch.parallel import group as G
from iris_lama_tpu_torch.parallel import map_rebuild as treb
from iris_lama_tpu_torch.sdm.distance import edt2d as tdist_edt2d
from iris_lama_tpu_torch.sdm import mapping as tmap
from iris_lama_tpu_torch.sdm import pool as tpool
from iris_lama_tpu_torch.utils import state as tstate

TABLE = ("keys", "slots", "free_slots", "n_free", "overflow")
OPTS = dict(resolution=0.1, patch_size=16, max_range=4.0, l2_max=0.5,
            capacity=512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scans(n=12, beams=90):
    """tests/test_map_rebuild.py's _scans()."""
    data = simulator.simulate(simulator.SimConfig(
        n_steps=n, seed=9, laser=simulator.LaserSpec(n_beams=beams,
                                                     max_range=4.0)))
    poses, points, masks, origins = [], [], [], []
    for k in range(n):
        pts, msk, org = pad_scan(data.clouds[k], 128)
        g = data.poses_gt[k]
        poses.append([g[0], g[1], np.cos(g[2]), np.sin(g[2])])
        points.append(pts)
        masks.append(msk)
        origins.append(org)
    return (np.asarray(poses, np.float32), np.asarray(points, np.float32),
            np.asarray(masks), np.asarray(origins, np.float32))


@pytest.fixture(scope="module")
def both():
    """The JAX rebuild (run once for the module) and the port's inputs."""
    jcfg = JOptions(**OPTS).mapping_config()
    tcfg = Slam2DOptions(**OPTS).mapping_config()
    scans = _scans()
    org, h, w = jreb.grid_bounds(jcfg, jcfg.geometry, scans[0])
    dense = jreb.rebuild_dense(jcfg, *(jnp.asarray(a) for a in scans), org,
                               h, w)
    state = jreb.dense_to_state(jcfg, dense)
    return dict(tcfg=tcfg, scans=scans, bounds=(org, h, w), dense=dense,
                state=state)


def _port_dense(both):
    org, h, w = both["bounds"]
    return treb.rebuild_dense(both["tcfg"],
                              *(torch.as_tensor(a) for a in both["scans"]),
                              org, h, w)


def test_grid_bounds_equal(both):
    tcfg = both["tcfg"]
    org, h, w = treb.grid_bounds(tcfg, tcfg.geometry, both["scans"][0])
    jorg, jh, jw = both["bounds"]
    np.testing.assert_array_equal(org, jorg)
    assert (h, w) == (jh, jw)
    assert org.dtype == jorg.dtype


def test_rebuild_dense_bit_equal(both):
    got, want = _port_dense(both), both["dense"]
    np.testing.assert_array_equal(got.org_cell.numpy(),
                                  np.asarray(want.org_cell))
    for k in ("occ", "vis", "dist"):
        g, w_ = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert g.dtype == w_.dtype, k
        np.testing.assert_array_equal(g, w_, err_msg=k)
    assert int(got.vis.sum()) > 0 and (got.dist.numpy() == 0).any()


def test_rebuild_streams_sentinel(both):
    """Masked-out cells sit at the sentinel row h (JAX writes h into both
    coordinates, also on a grid where w != h); the deposit drops them."""
    org, h, w = both["bounds"]
    assert w != h
    scans = [torch.as_tensor(a) for a in both["scans"]]
    (hy, hx), (fy, fx) = treb._scan_cells(
        both["tcfg"], *scans, torch.as_tensor(org, dtype=torch.int32), h, w)
    for ly, lx in ((hy, hx), (fy, fx)):
        off = ly == h
        assert off.any() and (lx[off] == h).all()
        assert ((ly[~off] >= 0) & (ly[~off] < h) & (lx[~off] >= 0)
                & (lx[~off] < w)).all()


def test_dense_to_state_equal(both):
    got = tstate.map_to_numpy(treb.dense_to_state(both["tcfg"],
                                                  _port_dense(both)))
    want = both["state"]
    for f in TABLE:
        np.testing.assert_array_equal(got[f"table_{f}"],
                                      np.asarray(getattr(want.table, f)),
                                      err_msg=f)
    for k in ("occupied", "visited", "dist"):
        w_ = np.asarray(getattr(want, k))
        assert got[k].dtype == w_.dtype, k
        np.testing.assert_array_equal(got[k], w_, err_msg=k)


@pytest.mark.parametrize("world,crop", [(4, 0), (3, 6)])
def test_sharded_rebuild_equals_single_device(both, world, crop):
    """tests/test_map_rebuild.py::test_sharded_rebuild_equals_single_device
    on the port: the scans over ``world`` gloo ranks (12 scans, padded to a
    multiple of the ranks: 3 per rank at world 4, 4 at world 3), the grid's
    rows in strips with halos, against the JAX package's 8-device sharded
    rebuild of the same grid: counts, visits and meters bit-equal. The
    grid's rows (``h - crop``) are no multiple of 3 and, cropped by 6,
    no multiple of 4 either, so the strips are padded."""
    org, h, w = both["bounds"]
    h -= crop
    assert h % world or crop == 0
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("s",))
    jcfg = JOptions(**OPTS).mapping_config()
    want = jreb.rebuild_dense(jcfg, *(jnp.asarray(a) for a in both["scans"]),
                              org, h, w, mesh=mesh)
    got = G.run_ranks(ranks.rebuild, world,
                      args=(OPTS, both["scans"], (org, h, w)),
                      timeout=180)
    for r, d in enumerate(got):
        for k in ("occ", "vis", "dist"):
            np.testing.assert_array_equal(d[k], np.asarray(getattr(want, k)),
                                          err_msg=f"rank {r} {k}")


def test_edt_strips_world2():
    """edt_strips alone at world 2 (strips of 25 rows, R = 5) against the
    port's and the JAX package's one-device edt2d; a strip shorter than
    the radius raises on every rank before any exchange."""
    rng = np.random.default_rng(4)
    obst = rng.random((50, 37)) < 0.05
    got = G.run_ranks(ranks.edt_strips, 2, args=(obst, 35, 5), timeout=120)
    want = tdist_edt2d(torch.as_tensor(obst), 35, 5).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(jdist.edt2d(jnp.asarray(obst), 35, 5)))
    for d, short in got:
        np.testing.assert_array_equal(d, want)
        assert short


def test_rebuild_matches_sequential_update_maps(both):
    """tests/test_map_rebuild.py's oracle on the port alone: the rebuild
    against one update_maps a scan."""
    cfg = both["tcfg"]
    poses, points, masks, origins = (torch.as_tensor(a)
                                     for a in both["scans"])
    state = treb.dense_to_state(cfg, _port_dense(both))
    seq = tmap.slam_map_init(cfg, "cpu")
    for k in range(poses.shape[0]):
        seq, _ = tmap.update_maps(seq, cfg, poses[k], points[k], masks[k],
                                  origins[k])
    keys, kmask = tpool.active_keys(seq.table)
    keys = keys[kmask]
    s_seq = tpool.table_lookup(seq.table, keys).tolist()
    s_new = tpool.table_lookup(state.table, keys).tolist()
    checked = 0
    for a, b, key in zip(s_seq, s_new, keys.tolist()):
        if (seq.visited[a] > 0).any():
            assert b >= 0, f"rebuild lost patch {key}"
            assert torch.equal(state.occupied[b], seq.occupied[a])
            assert torch.equal(state.visited[b], seq.visited[a])
            checked += 1
        inside = seq.dist[a] < cfg.distance.max_dist - 1e-6
        if inside.any():
            np.testing.assert_allclose(state.dist[b][inside].numpy(),
                                       seq.dist[a][inside].numpy(),
                                       atol=1e-6)
    assert checked > 10
