"""The port's PFSlam2D pool-per-update path (``resident_window=False``)
against the JAX package's pool path and against the port's resident path,
on the CPU.

Configuration of tests/test_pf_resident.py (6 particles, 0.1 m cells,
16-cell patches, 120 beams padded to 128, ``capacity`` 1024, ``max_iter``
30, SimConfig(n_steps=70, seed=3)).

* Against the port's resident path (the JAX package's
  ``test_resident_bitwise_equals_legacy``): every particle bit-equal after
  every update, the weights too, and the best particle's map equal on a
  dense probe of the world. Both paths match on B6 over the same distances
  and update the same cells.
* Against the JAX package's pool path, on the JAX key stream: the port's
  B6 sums the normal equations in another order than the JAX CPU path's
  generic solver (tests/test_torch_pf_slam2d.py), so the free run is held
  as that file holds it (poses within 1 mm / 1e-3 rad, weights within
  rtol 1e-5, the same resample decisions) over its first updates, and the
  maps of the best particle on a dense probe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos import pf_slam2d as jpf
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.sdm import distance as jdist
from iris_lama_tpu.utils import simulator as jsim

from iris_lama_tpu_torch.algos import pf_slam2d as tpf
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.sdm import distance as tdist
from iris_lama_tpu_torch.sdm import pool as tpool
from iris_lama_tpu_torch.utils import state as tstate

from test_torch_pf_slam2d import JaxDraws, _angle

OPTS = dict(particles=6, resolution=0.1, patch_size=16, max_range=8.0,
            capacity=1024, trans_thresh=0.3, rot_thresh=0.3, max_iter=30,
            seed=7)
FREE_UPDATES = 11


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim():
    return jsim.simulate(jsim.SimConfig(
        n_steps=70, seed=3, laser=jsim.LaserSpec(n_beams=120, max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))


def _probe_cells(geo):
    xs = np.linspace(-10.0, 10.0, 101, dtype=np.float32)
    wx, wy = np.meshgrid(xs, xs)
    return geo.w2m(torch.as_tensor(np.stack([wx.ravel(), wy.ravel()], -1)))


def _probe(m, cfg, cells):
    """(capped distances, occupied, visited) of map ``m`` at ``cells``,
    allocation-agnostic (unallocated cells read max_dist and 0 counts)."""
    geo = cfg.geometry
    slots, idx = tpool.locate(m.table, geo, cells, m.dist.shape[0] - 1)
    d = tdist.cell_distance(m.table, m.dist, geo, cells,
                            cfg.distance.max_dist)
    return (d, torch.where(slots >= 0, m.occupied[idx], 0),
            torch.where(slots >= 0, m.visited[idx], 0))


def test_pool_path_bitwise_equals_resident(sim):
    """Same seed, same scans: the pool path's particles and weights equal
    the resident path's bit for bit after every update, through the
    resident path's re-orgs, and the best particle's maps agree cell for
    cell."""
    runs = {}
    for resident in (True, False):
        f = tpf.PFSlam2D(tpf.PFSlam2DOptions(**OPTS,
                                             resident_window=resident),
                         device="cpu")
        f.set_prior(Pose2D(*sim.poses_gt[0]))
        est = []
        for k in range(len(sim.clouds)):
            if f.update(sim.clouds[k], sim.odometry[k], sim.timestamps[k]):
                est.append(f.pset.pose.clone())
        runs[resident] = (torch.stack(est), f)
    (est_r, res), (est_p, pool) = runs[True], runs[False]
    assert res.n_reorgs >= 1, "re-org path not exercised"
    assert pool.pset.res_org is None and pool.n_reorgs == 0
    assert len(est_r) > 10
    assert torch.equal(est_r, est_p)
    assert torch.equal(res.pset.weight_sum, pool.pset.weight_sum)
    assert torch.equal(res.pset.weight, pool.pset.weight)
    assert pool._last_info["overflow"] == 0
    assert pool.escaped_count() == 0
    cfg = pool.options.mapping_config()
    cells = _probe_cells(cfg.geometry)
    for a, b in zip(_probe(res.particle_map(), cfg, cells),
                    _probe(pool.particle_map(), cfg, cells)):
        assert torch.equal(a, b)
    # the pool path's state dict carries no resident grids and reloads
    d = pool.state_dict()
    assert "res_org" not in d and "lineage" not in d
    again = tpf.PFSlam2D(pool.options, device="cpu")
    again.load_state_dict(d)
    assert again.pset.res_org is None
    assert torch.equal(again.pset.maps.visited, pool.pset.maps.visited)


def test_pool_path_matches_jax_pool_path(sim, tmp_path):
    """The JAX key stream through both pool paths over the whole run: the
    same accepted scans and resample decisions at every update; every
    particle within 1 mm / 1e-3 rad and its weight within rtol 1e-5 after
    each of the first updates (the twelfth sends one particle through a
    corridor step an ulp decides) and after the last (resamples have
    pruned the particles that parted); then the best particle's maps agree
    with the JAX package's on a dense probe, and ``save_occ_image`` writes
    its occupancy image."""
    j = jpf.PFSlam2D(jpf.PFSlam2DOptions(**OPTS, resident_window=False))
    t = tpf.PFSlam2D(tpf.PFSlam2DOptions(**OPTS, resident_window=False),
                     device="cpu",
                     draws=JaxDraws(jax.random.PRNGKey(OPTS["seed"])))
    j.set_prior(JPose2D(*sim.poses_gt[0]))
    t.set_prior(Pose2D(*sim.poses_gt[0]))

    def agree(tag):
        jp, tp = np.asarray(j.pset.pose), t.pset.pose.numpy()
        np.testing.assert_allclose(tp[:, :2], jp[:, :2], rtol=0, atol=1e-3,
                                   err_msg=tag)
        dth = np.angle(np.exp(1j * (_angle(tp) - _angle(jp))))
        assert np.abs(dth).max() <= 1e-3, (tag, dth)
        np.testing.assert_allclose(t.pset.weight.numpy(),
                                   np.asarray(j.pset.weight), rtol=1e-5,
                                   atol=1e-4, err_msg=tag)

    updates = resampled = 0
    for k in range(len(sim.clouds)):
        accepted = j.update(sim.clouds[k], sim.odometry[k], sim.timestamps[k])
        assert t.update(sim.clouds[k], sim.odometry[k],
                        sim.timestamps[k]) == accepted, k
        if not accepted or k == 0:
            continue
        updates += 1
        assert t._last_info["resampled"] == j._last_info["resampled"], k
        resampled += int(t._last_info["resampled"])
        if updates <= FREE_UPDATES:
            agree(f"update {updates}")
    assert updates > 4 * FREE_UPDATES and resampled >= 5
    agree("last update")
    assert t.best_particle_idx() == j.best_particle_idx()

    cfg = t.options.mapping_config()
    cells = _probe_cells(cfg.geometry)
    tm, jm = t.particle_map(), j.particle_map()
    jgeo = j.options.mapping_config().geometry
    jcells = jnp.asarray(cells.numpy())
    jd = jdist.cell_distance(jm.table, jm.dist, jgeo, jcells,
                             cfg.distance.max_dist)
    jm_t = tstate.map_from_numpy(
        {**{f"table_{f}": np.asarray(getattr(jm.table, f))
            for f in tstate.TABLE_FIELDS},
         "occupied": np.asarray(jm.occupied),
         "visited": np.asarray(jm.visited), "dist": np.asarray(jm.dist)},
        "cpu")
    got, want = _probe(tm, cfg, cells), _probe(jm_t, cfg, cells)
    np.testing.assert_array_equal(want[0].numpy(), np.asarray(jd))
    n = cells.shape[0]
    # a matched pose an ulp apart may move a cell or two (tests/
    # test_torch_pf_slam2d.py): at most 0.1% of the probe
    for a, b in zip(got, want):
        assert int((a != b).sum()) <= 1e-3 * n
    png = tmp_path / "pf.png"
    t.save_occ_image(str(png))
    from iris_lama_tpu_torch.sdm import export
    from iris_lama_tpu.sdm import export as jexport
    np.testing.assert_array_equal(
        export.read_image(str(png)),
        export.occupancy_to_image(tm, cfg.geometry)[::-1])
    assert export.occupancy_to_image(tm, cfg.geometry).shape == \
        jexport.occupancy_to_image(jm, jgeo).shape
