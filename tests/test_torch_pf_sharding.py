"""The port's particle sharding (iris_lama_tpu_torch/parallel/pf_sharding.py)
at world 4 on gloo against the JAX package's PF update on the CPU, and
against the port's own unsharded update.

tests/test_pf_slam2d.py's per-step comparison (8 particles at distinct
poses on a ring scan, 0.1 m cells, capacity 512, ``meas_sigma_gain`` 1):
from one synchronised state, step A (plain), step B (a forced resample:
weights spread so that Neff < N/2) and step C (a forced re-org: every pose
moved 20 m out of the safe zone), each started from the JAX update's
output as there. The JAX side is the unsharded ``pf_update_step`` (its
sharded run equals it, tests/test_pf_slam2d.py), its particle sets
carried across as numpy (``utils.state.pset_to_numpy``).

Tolerances, the JAX test's: weights within atol 1e-4 and rtol 1e-5 (the
JAX CPU path sums ``-d^2 / sigma`` per beam, the port divides B6's SSE),
normalised weights within 1e-5, lineage, window origin, resample and
re-org flags equal, map cells differing in under 1e-4 of the grid. Poses
within 5e-4, not the JAX test's 1e-4 (which compares one solver with
itself): the ring is rotationally symmetric, so a match's normal matrix is
near singular, and in step A particle 1 ends 1.6e-4 m from JAX's pose
after the same 4 iterations, the port's unsharded update as well (the
solvers' summation order). Against the port's unsharded update
(``pf.reorg`` when a particle left the safe zone, then
``pf.update_step``): bit-equal, poses included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos import pf_slam2d as jpf
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.utils import simulator as jsim
from iris_lama_tpu.utils.cloud import pad_scan

import torch_parallel_ranks as ranks
from iris_lama_tpu_torch.algos import pf_slam2d as tpf
from iris_lama_tpu_torch.parallel import group as G
from iris_lama_tpu_torch.sdm import mapping as tmap
from iris_lama_tpu_torch.utils import state as tstate

N = 8
WORLD = 4
OPTS = dict(particles=N, resolution=0.1, patch_size=16, max_range=4.0,
            capacity=512, trans_thresh=0.3, rot_thresh=0.3, max_iter=30,
            seed=7, meas_sigma_gain=1.0)
STEPS = ("plain", "resample", "reorg")
GRIDS = ("res_occ", "res_vis", "res_dist")
POOL = ("table_keys", "table_slots", "table_free_slots", "table_n_free",
        "table_overflow", "occupied", "visited", "dist")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring():
    ang = np.linspace(-np.pi, np.pi, 64, endpoint=False)
    pts = np.stack([2.0 * np.cos(ang), 2.0 * np.sin(ang), np.zeros(64)],
                   -1).astype(np.float32)
    return pts, np.ones(64, bool), np.zeros(3, np.float32)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's three steps: [(input set, u, output set, info)]
    as numpy, each input the previous step's output (B with its weights
    spread, C with its poses moved 20 m)."""
    opts = jpf.PFSlam2DOptions(**OPTS)
    pts, msk, org = (jnp.asarray(a) for a in _ring())
    rng = np.random.default_rng(11)
    xyr = np.stack([rng.uniform(-0.9, 0.9, N) + 0.013,
                    rng.uniform(-0.9, 0.9, N) + 0.017,
                    rng.uniform(-0.3, 0.3, N)], -1)
    pset = jpf.particles_init(opts, jnp.asarray([0, 0, 1, 0], jnp.float32))
    pset = pset._replace(pose=jnp.asarray(
        [JPose2D(*p).se2_array() for p in xyr], jnp.float32))
    pset = jax.jit(lambda ps: jpf.pf_first_step(opts, ps, pts, msk, org))(
        pset)
    update = jax.jit(lambda ps, k: jpf.pf_update_step(opts, ps, k, pts, msk,
                                                      org))
    out = []
    for k, name in enumerate(STEPS, start=1):
        if name == "resample":
            spread = jnp.arange(N, dtype=jnp.float32) * 8.0
            pset = pset._replace(weight=spread, weight_sum=spread)
        if name == "reorg":
            shift = JPose2D(20.0, 0.0, 0.0)
            pset = pset._replace(pose=jnp.asarray(
                [(JPose2D.from_se2_array(p) + shift).se2_array()
                 for p in np.asarray(pset.pose)], jnp.float32))
        key = jax.random.PRNGKey(k)
        u = float(jax.random.uniform(key))
        before = tstate.pset_to_numpy(jax.device_get(pset))
        pset, info = update(pset, key)
        out.append((before, u, tstate.pset_to_numpy(jax.device_get(pset)),
                    {k_: np.asarray(v) for k_, v in info.items()}))
    return out


@pytest.fixture(scope="module")
def sharded(jax_steps):
    """The port's sharded update at world 4 from each JAX input."""
    got = G.run_ranks(ranks.pf_steps, WORLD,
                      args=(OPTS, [(s[0], s[1]) for s in jax_steps],
                            _ring()), timeout=300)
    return got[0]


def _unsharded(before, u):
    """The port's unsharded update from ``before``: the re-org the JAX step
    takes inside when a particle left the safe zone, then update_step."""
    opts = tpf.PFSlam2DOptions(**OPTS)
    cfg = opts.mapping_config()
    ps = tstate.pset_from_numpy(opts, before, "cpu")
    safe = bool(torch.all(tmap.resident_safe(
        cfg, ps.res_org, cfg.geometry.w2m(ps.pose[:, :2]))))
    if not safe:
        ps = tpf.reorg(opts, ps)
    pts, msk, org = (torch.as_tensor(a) for a in _ring())
    ps, info = tpf.update_step(opts, ps, torch.tensor(u, dtype=torch.float32),
                               pts, msk, org)
    return tstate.pset_to_numpy(ps), info, not safe


@pytest.mark.parametrize("k", range(len(STEPS)), ids=STEPS)
def test_sharded_matches_jax(jax_steps, sharded, k):
    """tests/test_pf_slam2d.py::test_pf_sharded_equals_unsharded's checks,
    the port's world-4 update against JAX's."""
    _, _, want, jinfo = jax_steps[k]
    got, info = sharded[k]
    tag = STEPS[k]
    assert bool(info["resampled"]) == bool(jinfo["resampled"]), tag
    assert bool(info["reorged"]) == bool(jinfo["reorged"]), tag
    np.testing.assert_allclose(got["pose"], want["pose"], atol=5e-4,
                               err_msg=tag)
    np.testing.assert_allclose(got["weight"], want["weight"], atol=1e-4,
                               rtol=1e-5, err_msg=tag)
    np.testing.assert_allclose(got["normalized"], want["normalized"],
                               atol=1e-5, err_msg=tag)
    np.testing.assert_array_equal(got["lineage"], want["lineage"],
                                  err_msg=tag)
    np.testing.assert_array_equal(got["res_org"], want["res_org"],
                                  err_msg=tag)
    for name in GRIDS + POOL:
        frac = (got[name] != want[name]).mean()
        assert frac < 1e-4, (tag, name, frac)
    # the step's own premise, as in the JAX test
    assert bool(jinfo["resampled"]) == (tag == "resample")
    assert bool(jinfo["reorged"]) == (tag == "reorg")


@pytest.mark.parametrize("k", range(len(STEPS)), ids=STEPS)
def test_sharded_equals_unsharded(jax_steps, sharded, k):
    """The world-4 update is the port's unsharded update bit for bit, and
    its info the same; the resample moved rows between ranks."""
    before, u, _, _ = jax_steps[k]
    want, winfo, reorged = _unsharded(before, u)
    got, info = sharded[k]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{STEPS[k]} {name}")
    assert info["reorged"] == reorged
    for key in ("neff", "resampled", "escaped", "overflow",
                "match_iters_max", "match_iters_mean"):
        assert info[key] == winfo[key].item(), key
    if STEPS[k] == "plain":
        assert info["exchange_bytes"] == 0
    else:
        assert info["exchange_bytes"] > 0


def _sim_scans():
    """tests/test_pf_slam2d.py::test_pf_sharded_step_runs_on_mesh's data:
    the simulator's first and fourth scans, padded to 128 beams."""
    data = jsim.simulate(jsim.SimConfig(
        n_steps=6, seed=2, laser=jsim.LaserSpec(n_beams=120, max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))
    return data, pad_scan(data.clouds[0], 128), pad_scan(data.clouds[3], 128)


@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "pool"])
def test_sharded_step_runs_on_group(resident):
    """test_pf_sharded_step_runs_on_mesh's run on the port, both paths: a
    first step on the whole set, the update at world 4 from it; finite
    poses of shape (8, 4), equal to the unsharded update (the pool path's
    ``pool_update_step``), every particle's rows back on rank 0."""
    data, first, scan = _sim_scans()
    opts_kw = dict(OPTS, max_range=8.0, resident_window=resident)
    opts = tpf.PFSlam2DOptions(**opts_kw)
    ps = tpf.particles_init(opts, JPose2D(*data.poses_gt[0]).se2_array(),
                            "cpu")
    tpf.first_step(opts, ps, *(torch.as_tensor(a) for a in first))
    before = tstate.pset_to_numpy(ps)
    u = 0.37
    got, info = G.run_ranks(ranks.pf_steps, WORLD,
                            args=(opts_kw, [(before, u)], scan),
                            timeout=300)[0][0]
    assert got["pose"].shape == (N, 4)
    assert np.isfinite(got["pose"]).all()
    ps = tstate.pset_from_numpy(opts, before, "cpu")
    step = tpf.update_step if resident else tpf.pool_update_step
    want, _ = step(opts, ps, torch.tensor(u, dtype=torch.float32),
                   *(torch.as_tensor(a) for a in scan))
    want = tstate.pset_to_numpy(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_sharded_motion():
    """make_sharded_motion at world 4: each rank's rows of the full draw,
    the whole set equal to draw_from_motion on one process."""
    opts_kw = dict(OPTS)
    opts = tpf.PFSlam2DOptions(**opts_kw)
    g = torch.Generator().manual_seed(3)
    pose = tpf.draw_from_motion(opts, torch.randn((N, 3), generator=g),
                                torch.tensor([0.3, 0.1, 1.0, 0.0]),
                                torch.tensor([[0.0, 0.0, 1.0, 0.0]] * N))
    eps = torch.randn((N, 3), generator=g)
    od = torch.tensor([0.2, -0.05, np.cos(0.1), np.sin(0.1)],
                      dtype=torch.float32)
    got = G.run_ranks(ranks.pf_motion, WORLD,
                      args=(opts_kw, pose.numpy(), eps.numpy(), od.numpy()),
                      timeout=120)[0]
    np.testing.assert_array_equal(
        got, tpf.draw_from_motion(opts, eps, od, pose).numpy())
