"""Squared-distance windows wider than int8, in the port, on the CPU.

``DistanceConfig.sq_dtype`` stores a window's capped squared distances as
int8 up to ``max_sqdist`` 127, uint8 up to 255, int16 up to 32767 and int32
beyond: at the default ``l2_max`` of 0.5 m, uint8 from 4.5 cm cells down,
int16 from 3.3 cm. Every kernel that reads a window (B2, B4/B6, B5) has an
instantiation for each width; their plain versions run here.

* Slam2D at 4 cm (uint8) and 3 cm (int16) cells, the first 10 scans of
  the 120-beam test world (a 120-step loop: ~0.3 m apart, re-orgs
  included), against the JAX package: the same accepted scans, no escape,
  poses within 1e-5 m / rad (the packages sum the normal equations in
  other orders: a few ulp), the resident window of the expected width.
* The plain B2, B4, B5 and B6 on uint8 and int16 windows that are exact
  widenings of an int8 window: bit-equal to the int8 results (the kernels
  on the card are held to the same in tests/test_torch_cuda.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos.slam2d import Slam2D as JSlam2D
from iris_lama_tpu.algos.slam2d import Slam2DOptions as JOptions
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.utils import simulator as jsim
from iris_lama_tpu.utils.cloud import beam_bucket, pad_scan

from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.ops import gn_batch as tgb
from iris_lama_tpu_torch.ops import gn_solve as tgs
from iris_lama_tpu_torch.ops import match_eval as tme
from iris_lama_tpu_torch.ops import select4 as ts4

N_SCANS = 10


@functools.lru_cache(maxsize=None)
def _world():
    data = jsim.simulate(jsim.SimConfig(
        n_steps=120, seed=6,
        laser=jsim.LaserSpec(n_beams=120, max_range=8.0)))
    return data, [pad_scan(c, beam_bucket(120))
                  for c in data.clouds[:N_SCANS]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("res,dtype", [(0.04, torch.uint8),
                                       (0.03, torch.int16)])
def test_slam2d_fine_cells_match_jax(res, dtype):
    data, padded = _world()
    opts = dict(resolution=res, patch_size=16, max_range=8.0,
                trans_thresh=0.2, rot_thresh=0.2, capacity=4096)
    js = JSlam2D(JOptions(**opts))
    js.set_prior(JPose2D(*data.poses_gt[0]))
    odoms = data.odometry[:N_SCANS]
    jacc = js.update_many_prepadded(
        [tuple(jnp.asarray(a) for a in p) for p in padded], odoms)
    ts = Slam2D(Slam2DOptions(**opts), device="cpu")
    ts.set_prior(Pose2D(*data.poses_gt[0]))
    tacc = ts.update_many_prepadded(
        [tuple(torch.as_tensor(a) for a in p) for p in padded], odoms)
    assert ts._res_dist.dtype == dtype
    assert str(js._res_dist.dtype) == str(dtype).removeprefix("torch.")
    assert tacc == jacc and len(tacc) == N_SCANS
    assert ts.escaped_count() == js.escaped_count() == 0
    assert ts.n_reorgs >= 1
    jt, tt = js.trajectory(), ts.trajectory()
    assert np.abs(jt[:, :2] - tt[:, :2]).max() <= 1e-5
    assert np.abs(np.angle(np.exp(1j * (jt[:, 2] - tt[:, 2])))).max() <= 1e-5


# ---------------------------------------------------------------------------
# the plain kernels on exact widenings of an int8 window
# ---------------------------------------------------------------------------

H, W, B = 72, 90, 300


def _int8_case(p, seed):
    """p int8 windows (cap 100), a scan of B beams near their walls with
    90% kept, start states a few cells off."""
    rng = np.random.default_rng(seed)
    obst = np.zeros((H, W), bool)
    obst[10, 5:80] = True
    obst[10:60, 70] = True
    ys, xs = np.nonzero(obst)
    yy, xx = np.mgrid[0:H, 0:W]
    d2 = ((yy[..., None] - ys) ** 2 + (xx[..., None] - xs) ** 2).min(-1)
    grids = np.stack([np.roll(np.minimum(d2, 100), q, 1)
                      for q in range(p)]).astype(np.int8)
    k = rng.integers(0, len(ys), B)
    pts = np.stack([(xs[k] + 0.5) * 0.1, (ys[k] + 0.5) * 0.1],
                   -1).astype(np.float32)
    mask = rng.uniform(size=B) < 0.9
    off = rng.uniform(-0.15, 0.15, (p, 3)).astype(np.float32)
    st0 = np.stack([off[:, 0], off[:, 1], np.cos(off[:, 2]),
                    np.sin(off[:, 2])], -1).astype(np.float32)
    return grids, pts, mask, st0


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16])
@pytest.mark.parametrize("kernel", ["select4", "gn_solve", "gn_eval",
                                    "gn_batch"])
def test_plain_kernels_on_widened_windows(kernel, dtype):
    grids, pts, mask, st0 = _int8_case(3, 5)
    g8 = torch.as_tensor(grids)
    gw = g8.to(dtype)
    assert torch.equal(gw.to(torch.int32), g8.to(torch.int32))
    rng = np.random.default_rng(6)
    if kernel == "select4":
        ly = torch.as_tensor(rng.integers(-3, H + 3, B).astype(np.int32))
        lx = torch.as_tensor(rng.integers(-3, W + 3, B).astype(np.int32))
        a, b = ts4.select4_sq(gw[0], ly, lx), ts4.select4_sq(g8[0], ly, lx)
        assert torch.equal(a, b)
        return
    kw = dict(max_dist=1.0, res=0.1, scale=10.0, cauchy_c=0.15)
    if kernel == "gn_eval":
        ops = [torch.as_tensor(rng.integers(-3, n + 3, (3, B)).astype(
            np.int32)) for n in (H, W)]
        ops += [torch.as_tensor(rng.uniform(size=(3, B)).astype(np.float32))
                for _ in range(2)]
        ops += [torch.as_tensor(rng.uniform(-5, 5, (3, B)).astype(
            np.float32)) for _ in range(2)]
        ops.append(torch.as_tensor(mask, dtype=torch.float32).expand(3, B))
        a = tme.gn_eval_sq(gw, *ops, **kw)
        b = tme.gn_eval_sq(g8, *ops, **kw)
        assert torch.equal(a, b) and bool(a.abs().sum() > 0)
        return
    org = torch.zeros((3, 2), dtype=torch.int32)
    kw.update(cell_offset=0, eps1=1e-4, eps2=1e-4, max_iter=30,
              want_lik=True)
    tp, tm = torch.as_tensor(pts), torch.as_tensor(mask)
    if kernel == "gn_solve":       # a scan per particle
        tp, tm = tp.expand(3, B, 2), tm.expand(3, B)
        mod = tgs
    else:
        mod = tgb
    st = torch.as_tensor(st0)
    a = mod.solve_window_sq(gw, org, st, tp, tm, **kw)
    b = mod.solve_window_sq(g8, org, st, tp, tm, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a[1].sum()) >= 3        # the starts drive the loop
