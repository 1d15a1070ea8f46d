"""The port's Loc2D against the JAX package's, on the CPU.

The fixed map is built once by the JAX Slam2D (tests/test_loc2d.py's
sim: 0.1 m cells, 16-cell patches, the first 60 scans, and the first 100
for global localisation) and carried across with
``utils.state.locmaps_from_numpy``, so both packages localise on one
identical map. Each match mode of the port runs against the JAX driver:
``generic`` against its default (float windows), ``sq``, ``solve`` and
``fused`` against ``IRIS_LOC_SQ=1`` (int8 windows; on the CPU the JAX
package solves those with its generic solver). Required: the same accepted
scans, poses within 1e-4 m / 1e-4 rad, covariance rtol 1e-3 (it inverts a
normal matrix whose sums are taken in another order), RMSE rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos import loc2d as jloc
from iris_lama_tpu.algos.slam2d import Slam2D as JSlam2D
from iris_lama_tpu.algos.slam2d import Slam2DOptions as JSlam2DOptions
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.utils import simulator as jsim
from iris_lama_tpu.utils.cloud import beam_bucket, pad_scan

from iris_lama_tpu_torch.algos import loc2d as tloc
from iris_lama_tpu_torch.algos import slam2d as tslam
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.sdm import mapping as tmap
from iris_lama_tpu_torch.utils import state as tstate
from iris_lama_tpu_torch.utils import trace

OPTS = dict(resolution=0.1, patch_size=16, l2_max=0.5, trans_thresh=0.2,
            rot_thresh=0.2, max_range=8.0)
N_MAP = 60
MODES = ("generic", "sq", "solve", "fused")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxLocDraws:
    """The JAX driver's key stream as a draw source for the port: one split
    per gloc round, then a split into the (n, 2) and (n,) uniforms."""

    def __init__(self, key):
        self.key = key
        self._next = None

    def __call__(self, kind, shape):
        assert kind == "uniform"
        if self._next is None:
            self.key, sub = jax.random.split(self.key)
            k1, self._next = jax.random.split(sub)
            return np.array(jax.random.uniform(k1, shape))
        k2, self._next = self._next, None
        return np.array(jax.random.uniform(k2, shape))


@pytest.fixture(scope="module")
def world():
    """(sim, JAX maps of the first 60 scans, of the first 100, the JAX
    Slam2D's map state after 60 scans as numpy)."""
    data = jsim.simulate(jsim.SimConfig(
        n_steps=120, seed=4,
        laser=jsim.LaserSpec(n_beams=120, max_range=8.0)))
    slam = JSlam2D(JSlam2DOptions(resolution=0.1, patch_size=16,
                                  max_range=8.0, trans_thresh=0.2,
                                  rot_thresh=0.2, capacity=4096))
    slam.set_prior(JPose2D(*data.poses_gt[0]))
    for k in range(100):
        slam.update(data.clouds[k], data.odometry[k], data.timestamps[k])
        if k == N_MAP - 1:
            m = slam.map
            maps60 = jloc.maps_from_slam(m, slam.cfg)
            slam_np = {"occupied": np.asarray(m.occupied),
                       "visited": np.asarray(m.visited),
                       "dist": np.asarray(m.dist),
                       **{f"table_{f}": np.asarray(getattr(m.table, f))
                          for f in tstate.TABLE_FIELDS}}
    maps100 = jloc.maps_from_slam(slam.map, slam.cfg)
    return data, maps60, maps100, slam_np


def _port_maps(jmaps):
    return tstate.locmaps_from_numpy(tstate.locmaps_to_numpy(jmaps), "cpu")


def _run_jax(data, jmaps, sq: bool):
    with pytest.MonkeyPatch.context() as mp:
        if sq:
            mp.setenv("IRIS_LOC_SQ", "1")
        jloc._make_loc_programs.cache_clear()
        try:
            loc = jloc.Loc2D(jloc.Loc2DOptions(**OPTS), maps=jmaps)
            loc.set_prior(JPose2D(*data.poses_gt[0]))
            acc = [k for k in range(N_MAP)
                   if loc.update(data.clouds[k], data.odometry[k])]
            return (acc, loc.trajectory(), loc.covariance(), loc.rmse())
        finally:
            jloc._make_loc_programs.cache_clear()


@pytest.fixture(scope="module")
def jax_runs(world):
    data, maps60, _, _ = world
    return {sq: _run_jax(data, maps60, sq) for sq in (False, True)}


def _port_loc(maps, mode, **kw):
    return tloc.Loc2D(tloc.Loc2DOptions(**dict(OPTS, **kw)), maps=maps,
                      device="cpu", match=mode)


def _loc_reads() -> int:
    """Loc2D's host reads so far: the window check's pose cell and the
    IRLS stop flag."""
    got = trace.counts()
    return got.get("reads.loc_cell", 0) + got.get("reads.irls_stop", 0)


def _angle_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (a - b))))


@pytest.mark.parametrize("mode", MODES)
def test_loc2d_matches_jax(world, jax_runs, mode):
    data, maps60, _, _ = world
    jacc, jtraj, jcov, jrmse = jax_runs[mode != "generic"]
    loc = _port_loc(_port_maps(maps60), mode)
    loc.set_prior(Pose2D(*data.poses_gt[0]))
    acc = [k for k in range(N_MAP)
           if loc.update(data.clouds[k], data.odometry[k])]
    traj = loc.trajectory()
    assert acc == jacc and len(traj) == len(jtraj) > 20
    assert np.abs(traj[:, :2] - jtraj[:, :2]).max() <= 1e-4
    assert _angle_diff(traj[:, 2], jtraj[:, 2]).max() <= 1e-4
    np.testing.assert_allclose(loc.covariance(), jcov, rtol=1e-3)
    np.testing.assert_allclose(loc.rmse(), jrmse, rtol=1e-4)
    err = np.linalg.norm(traj[:, :2] - data.poses_gt[1:N_MAP, :2], axis=1)
    assert err.mean() < 0.15                   # test_loc2d_tracks_on_...
    assert loc.n_gathers >= 1


@pytest.mark.parametrize("mode", MODES)
def test_update_many_matches_sequential(world, mode):
    """test_loc2d_update_many_matches_sequential: the replay of a staged
    log equals the per-scan driver."""
    data, maps60, _, _ = world
    maps = _port_maps(maps60)
    nb = beam_bucket(120)
    staged = []
    for k in range(N_MAP):
        p, m, _ = pad_scan(data.clouds[k], nb)
        staged.append((torch.as_tensor(np.ascontiguousarray(p[:, :2])),
                       torch.as_tensor(m)))
    a = _port_loc(maps, mode)
    a.set_prior(Pose2D(*data.poses_gt[0]))
    n_seq = sum(bool(a.update(data.clouds[k], data.odometry[k]))
                for k in range(N_MAP))
    b = _port_loc(maps, mode)
    b.set_prior(Pose2D(*data.poses_gt[0]))
    reads = _loc_reads()
    accepted = b.update_many_prepadded(staged, list(data.odometry), chunk=8)
    # at least the window check of every accepted update
    assert _loc_reads() - reads >= len(accepted)
    assert n_seq == len(accepted) + 1
    np.testing.assert_allclose(a.trajectory(), b.trajectory(), atol=1e-6)
    np.testing.assert_allclose(a._pose_dev.numpy(), b._pose_dev.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(a.covariance(), b.covariance(), atol=1e-8)
    assert abs(a.rmse() - b.rmse()) < 1e-6


def test_global_localization_matches_jax(world):
    """test_loc2d_global_localization_recovers on the JAX key stream: the
    first gloc round picks the same hypothesis, and the kidnapped robot
    ends within 0.5 m of the truth and within 1 mm of the JAX driver."""
    data, _, maps100, _ = world
    k = 40
    kw = dict(resolution=0.1, patch_size=16, l2_max=0.5, max_range=8.0,
              gloc_particles=2000, gloc_thresh=0.25)
    maps = _port_maps(maps100)
    # the first round alone, from the same key (jitted, as the JAX driver
    # runs it)
    nb = beam_bucket(120)
    p, m, _ = pad_scan(data.clouds[k], nb)
    probe = tloc.Loc2D(tloc.Loc2DOptions(**kw), maps=maps, device="cpu")
    jgeo = jloc.Loc2D(jloc.Loc2DOptions(**kw), maps=maps100).geo
    key = jax.random.PRNGKey(9)
    _, sub = jax.random.split(key)
    jround = jax.jit(jloc.global_localization_kernel,
                     static_argnums=(1, 2, 6))
    jpose, jsse = jround(maps100, jgeo, probe.max_dist, jnp.asarray(p[:, :2]),
                         jnp.asarray(m), sub, 2000)
    draws = JaxLocDraws(key)

    def draw(kind, shape):
        return torch.as_tensor(draws(kind, shape), dtype=torch.float32)

    tpose, tsse = tloc.global_localization_kernel(
        maps, probe.geo, probe.max_dist, torch.as_tensor(p[:, :2].copy()),
        torch.as_tensor(m), 2000, draw)
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=1e-5)
    np.testing.assert_allclose(float(tsse), float(jsse), rtol=1e-4)

    # the kidnapped run
    jl = jloc.Loc2D(jloc.Loc2DOptions(**kw), maps=maps100, seed=9)
    tl = tloc.Loc2D(tloc.Loc2DOptions(**kw), maps=maps, device="cpu",
                    draws=JaxLocDraws(jax.random.PRNGKey(9)))
    for loc, pose in ((jl, JPose2D), (tl, Pose2D)):
        loc.set_prior(pose(25.0, 3.0, 1.0))
        loc.trigger_global_localization()
        for j in (k, k + 1, k + 2, k + 3):
            loc.update(data.clouds[j], data.odometry[j], 0.0,
                       force_update=True)
    err = np.linalg.norm(tl.pose().xy() - data.poses_gt[k + 3][:2])
    assert err < 0.5
    assert np.abs(tl.pose().xy() - jl.pose().xy()).max() <= 1e-3
    assert tl.gloc_cur_iter == jl.gloc_cur_iter
    assert tl.do_global_localization == jl.do_global_localization


def test_sampling_covariance_matches_jax(world):
    """The Olson sampled covariance against the JAX kernel (the atol of
    test_sampling_covariance_matches_numpy_oracle), and a blended update."""
    data, maps60, _, _ = world
    maps = _port_maps(maps60)
    loc = _port_loc(maps, "generic")
    p, m, _ = pad_scan(data.clouds[5], 128)
    pose = Pose2D(*data.poses_gt[5]).se2_array()
    n_step = max(int(m.sum()) // 100, 1)
    want = jloc.sampling_covariance_kernel(
        maps60, jloc.Loc2D(jloc.Loc2DOptions(**OPTS), maps=maps60).geo,
        loc.max_dist, jnp.asarray(p[:, :2]), jnp.asarray(m),
        jnp.asarray(pose), 0.1, n_step)
    got = tloc.sampling_covariance_kernel(
        maps, loc.geo, loc.max_dist, torch.as_tensor(p[:, :2]),
        torch.as_tensor(m), torch.as_tensor(pose), 0.1, n_step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    # test_loc2d_sampling_covariance_blend, against the JAX driver
    kw = dict(resolution=0.1, patch_size=16, max_range=8.0, cov_blend=0.5)
    jl = jloc.Loc2D(jloc.Loc2DOptions(**kw), maps=maps60)
    tl = tloc.Loc2D(tloc.Loc2DOptions(**kw), maps=maps, device="cpu")
    for loc, pose_t in ((jl, JPose2D), (tl, Pose2D)):
        loc.set_prior(pose_t(*data.poses_gt[0]))
        loc.update(data.clouds[0], data.odometry[0], 0.0, force_update=True)
        loc.update(data.clouds[5], data.odometry[5], 0.0, force_update=True)
    np.testing.assert_allclose(tl.covariance(), jl.covariance(), rtol=1e-3,
                               atol=1e-9)
    np.testing.assert_allclose(tl.rmse(), jl.rmse(), rtol=1e-4)


def test_pool_match_and_rmse_match_jax(world):
    """solve_pool (the scan match straight on the pool) from a pose 10 cm /
    0.05 rad off the truth, and the nearest-cell RMSE (rmse_cells) at the
    truth, against the JAX functions."""
    from iris_lama_tpu.match import match_surface_2d as jmatch
    from iris_lama_tpu.nlls import solver as jsolver
    from iris_lama_tpu_torch.match import match_surface_2d as tmatch

    data, maps60, _, _ = world
    maps = _port_maps(maps60)
    loc = _port_loc(maps, "generic")
    jl = jloc.Loc2D(jloc.Loc2DOptions(**OPTS), maps=maps60)
    p, m, _ = pad_scan(data.clouds[30], beam_bucket(120))
    x, y, th = data.poses_gt[30]
    start = Pose2D(x + 0.1, y - 0.05, th + 0.05).se2_array()
    truth = Pose2D(x, y, th).se2_array()
    jd, td = maps60.distance, maps.distance
    jargs = (jnp.asarray(p[:, :2]), jnp.asarray(m))
    targs = (torch.as_tensor(p[:, :2].copy()), torch.as_tensor(m))
    jsopts = jsolver.SolverOptions(max_iterations=100, strategy="gn",
                                   robust=jloc.CAUCHY_SCAN)
    ref = jmatch.solve_pool(jd.table, jd.dist, jl.geo, loc.max_dist, *jargs,
                            jnp.asarray(start), jsopts)
    out = tmatch.solve_pool(td.table, td.dist, loc.geo, loc.max_dist,
                            *targs, torch.as_tensor(start), loc.sopts)
    assert int(out.iterations) == int(ref.iterations) >= 2
    np.testing.assert_allclose(out.state.numpy(), np.asarray(ref.state),
                               rtol=1e-4, atol=1e-5)
    want = jmatch.rmse_cells(jd.table, jd.dist, jl.geo, loc.max_dist,
                             *jargs, jnp.asarray(truth))
    got = tmatch.rmse_cells(td.table, td.dist, loc.geo, loc.max_dist,
                            *targs, torch.as_tensor(truth))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_maps_from_slam_bit_equal(world):
    """The port's maps_from_slam on the JAX Slam2D's map (carried across
    with map_from_numpy) equals the JAX conversion; LocMaps round-trip."""
    _, maps60, _, slam_np = world
    port_map = tstate.map_from_numpy(slam_np, "cpu")
    assert isinstance(port_map, tmap.SlamMapState)
    got = tstate.locmaps_to_numpy(tloc.maps_from_slam(port_map, None))
    want = tstate.locmaps_to_numpy(maps60)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    again = tstate.locmaps_to_numpy(tstate.locmaps_from_numpy(got, "cpu"))
    for k in want:
        np.testing.assert_array_equal(again[k], got[k], err_msg=k)


def test_loc2d_adopts_map_patch_size(world):
    data, maps60, _, _ = world
    loc = tloc.Loc2D(tloc.Loc2DOptions(resolution=0.1, max_range=8.0),
                     maps=_port_maps(maps60), device="cpu", match="solve")
    assert loc.options.patch_size == 16
    loc.set_prior(Pose2D(*data.poses_gt[0]))
    loc.update(data.clouds[0], data.odometry[0], 0.0, force_update=True)
    loc.update(data.clouds[5], data.odometry[5], 0.0, force_update=True)
    assert np.isfinite(loc.pose().xyr()).all()
    assert np.isfinite(loc.covariance()).all()
    # new maps drop the resident window: the next update gathers anew
    gathers = loc.n_gathers
    loc.set_maps(_port_maps(maps60))
    loc.update(data.clouds[6], data.odometry[6], 0.0, force_update=True)
    assert loc.n_gathers == gathers + 1


@pytest.mark.parametrize("mode", ["solve", "fused", "nonsense"])
def test_loc2d_refuses_what_a_mode_cannot_serve(mode):
    lm = tloc.Loc2DOptions(strategy="lm")
    with pytest.raises(ValueError):
        tloc.Loc2D(lm, device="cpu", match=mode)
    if mode != "nonsense":
        tloc.Loc2D(dataclasses.replace(lm, strategy="gn"), device="cpu",
                   match=mode)
    tloc.Loc2D(lm, device="cpu", match="generic")


def test_loc2d_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloc.Loc2D(tloc.Loc2DOptions(), match="solve")
    assert tslam.resolve_device("cpu").type == "cpu"
