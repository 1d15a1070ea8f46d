"""The port's CUDA kernels against their plain PyTorch versions on the card,
and its paths on the card against the CPU.

Marked ``gpu``: every test skips without a CUDA device. This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from iris_lama_tpu_torch.algos import loc2d
from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2D, PFSlam2DOptions
from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.ops import edt_pallas, gn_batch, gn_solve
from iris_lama_tpu_torch.ops import match_eval, scatter_matmul
from iris_lama_tpu_torch.ops import scatter_pallas, scatter_sorted, select4
from iris_lama_tpu_torch.utils import simulator, state
from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("order", ["beam_major", "shuffled", "sentinels"])
def test_deposit_kernel_bit_exact(cuda, order):
    g = torch.Generator(device=cuda).manual_seed(0)
    h = w = 448
    n = 768 * 202
    ly = torch.randint(-4, h + 4, (n,), generator=g, device=cuda,
                       dtype=torch.int32)
    lx = torch.randint(-4, w + 4, (n,), generator=g, device=cuda,
                       dtype=torch.int32)
    if order == "beam_major":
        ly, _ = torch.sort(ly)
    elif order == "sentinels":
        ly = torch.where(torch.rand(n, generator=g, device=cuda) < 0.3, h, ly)
    got = scatter_matmul.deposit_counts(ly, lx, h, w)
    want = scatter_matmul.deposit_counts_plain(ly, lx, h, w)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw", [488, 576])       # Slam2D's, Loc2D's window
def test_select4_kernel_bit_exact(cuda, hw):
    g = torch.Generator(device=cuda).manual_seed(1)
    h = w = hw
    grid = torch.randint(0, 101, (h, w), generator=g, device=cuda,
                         dtype=torch.int8)
    ly = torch.randint(-3, h + 3, (768,), generator=g, device=cuda,
                       dtype=torch.int32)
    lx = torch.randint(-3, w + 3, (768,), generator=g, device=cuda,
                       dtype=torch.int32)
    assert torch.equal(select4.select4_sq(grid, ly, lx),
                       select4.select4_sq_plain(grid, ly, lx))


@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_edt_kernel_bit_exact(cuda, density):
    g = torch.Generator(device=cuda).manual_seed(2)
    m = torch.rand((448, 400), generator=g, device=cuda) < density
    for cap, r in ((100, 10), (25, 5)):
        assert torch.equal(edt_pallas.edt2d(m, cap, r),
                           edt_pallas.edt2d_plain(m, cap, r))


def test_launchers_refuse_what_they_do_not_take(cuda):
    ly = torch.zeros(16, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        scatter_matmul.deposit_counts(ly, ly, 8, 8)
    grid = torch.zeros((8, 8), dtype=torch.float32, device=cuda)
    idx = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        select4.select4_sq(grid, idx, idx)
    with pytest.raises(TypeError):
        select4.select4_sq(grid.to(torch.int8), idx.long(), idx)
    m = torch.zeros((8, 16), dtype=torch.bool, device=cuda).t()
    with pytest.raises(ValueError):
        edt_pallas.edt2d(m, 25, 5)


def test_slam2d_on_card_matches_cpu(cuda):
    data = simulator.simulate(simulator.SimConfig(
        n_steps=30, seed=6,
        laser=simulator.LaserSpec(n_beams=120, max_range=8.0)))
    opts = Slam2DOptions(resolution=0.1, patch_size=16, max_range=8.0,
                         trans_thresh=0.2, rot_thresh=0.2, capacity=1024,
                         scroll_kp=5)
    padded = [pad_scan(c, beam_bucket(120)) for c in data.clouds]
    before = (scatter_matmul.deposit_pair.launches,
              select4.select4_sq.launches, edt_pallas.edt2d.launches)
    runs = []
    for dev in ("cpu", cuda):
        slam = Slam2D(opts, device=dev)
        slam.set_prior(Pose2D(*data.poses_gt[0]))
        staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
                  for p in padded]
        acc = slam.update_many_prepadded(staged, data.odometry)
        runs.append((acc, slam.trajectory(), slam.escaped_count()))
    (acc_c, tc, esc_c), (acc_g, tg, esc_g) = runs
    assert acc_c == acc_g and esc_c == esc_g == 0
    assert np.abs(tc[:, :2] - tg[:, :2]).max() <= 1e-3
    after = (scatter_matmul.deposit_pair.launches,
             select4.select4_sq.launches, edt_pallas.edt2d.launches)
    assert all(a > b for a, b in zip(after, before))


# ---------------------------------------------------------------------------
# the particle filter's kernels: B6 and the batched B1 / B3
# ---------------------------------------------------------------------------

def _pf_solve_case(dev, p=30, hw=432, b=768, seed=3):
    """PF shapes: p particles' s8 squared-distance windows of one wall
    layout shifted per particle, a scan of b beams on the walls (10% masked
    out) and start states up to ~0.2 m / 0.1 rad off. ``hw``: the window's
    side, or its (h, w) (each at least 401)."""
    g = torch.Generator().manual_seed(seed)
    obst = torch.zeros(hw if isinstance(hw, tuple) else (hw, hw),
                       dtype=torch.bool)
    obst[60, 40:400] = True
    obst[60:380, 380] = True
    obst[300, 100:380] = True
    obst[torch.randint(40, 400, (40,), generator=g),
         torch.randint(40, 400, (40,), generator=g)] = True
    sq = edt_pallas.edt2d_plain(obst, 100, 10).to(torch.int8)
    grids = torch.stack([torch.roll(sq, (q % 3, q % 5), (0, 1))
                         for q in range(p)])
    ys, xs = torch.nonzero(obst, as_tuple=True)
    k = torch.randint(0, len(ys), (b,), generator=g)
    pts = torch.stack([(xs[k] + 0.5) * 0.05, (ys[k] + 0.5) * 0.05], -1)
    mask = torch.rand(b, generator=g) < 0.9
    off = (torch.rand((p, 3), generator=g) - 0.5) * torch.tensor(
        [0.4, 0.4, 0.2])
    st0 = torch.stack([off[:, 0], off[:, 1], torch.cos(off[:, 2]),
                       torch.sin(off[:, 2])], -1)
    org = torch.full((p, 2), 262144, dtype=torch.int32)
    kw = dict(max_dist=0.5, res=0.05, scale=20.0, cell_offset=262144,
              cauchy_c=0.15, eps1=1e-4, eps2=1e-4, max_iter=50,
              want_lik=True)
    return [t.to(dev) for t in (grids, org, st0, pts, mask)], kw


def test_gn_batch_kernel_matches_plain(cuda):
    """B6 against its plain version on the card at the PF shapes: the plain
    version sums in the kernel's order and the kernel is built without FMA
    contraction, so every particle's state, iteration count, chi2 and SSE
    are bit-equal."""
    args, kw = _pf_solve_case(cuda)
    before = (gn_batch.solve_window_sq.launches,
              gn_solve.solve_window_sq.launches)
    got = gn_batch.solve_window_sq(*args, **kw)
    # B6 runs B4's kernel with the scan shared, counted as B6 only
    assert (gn_batch.solve_window_sq.launches,
            gn_solve.solve_window_sq.launches) == (before[0] + 1, before[1])
    want = gn_batch.solve_window_sq_plain(*args, **kw)
    assert int(got[1].sum()) > 30           # the starts drive the loop
    for name, a, w in zip(("state", "iterations", "chi2", "sum_d2"), got,
                          want):
        assert torch.equal(a, w), (name, a, w)


@pytest.mark.parametrize("order", ["beam_major", "shuffled", "sentinels"])
def test_batched_deposit_kernel_bit_exact(cuda, order):
    g = torch.Generator(device=cuda).manual_seed(4)
    p, h, w, n = 30, 448, 448, 768 * 202
    ly = torch.randint(-4, h + 4, (p, n), generator=g, device=cuda,
                       dtype=torch.int32)
    lx = torch.randint(-4, w + 4, (p, n), generator=g, device=cuda,
                       dtype=torch.int32)
    if order == "beam_major":
        ly, _ = torch.sort(ly, dim=1)
    elif order == "sentinels":
        ly = torch.where(torch.rand((p, n), generator=g, device=cuda) < 0.3,
                         h, ly)
    got = scatter_matmul.deposit_counts(ly, lx, h, w)
    assert got.shape == (p, h, w)
    assert torch.equal(got, scatter_matmul.deposit_counts_plain(ly, lx, h, w))


@pytest.mark.parametrize("r", [1, 5, 10])
@pytest.mark.parametrize("shape", [(61, 203), (448, 448), (33, 65)])
def test_edt_kernel_at_tile_edges(cuda, shape, r):
    """The tiled kernel at shapes that are no multiple of its 32 x 64 tile
    (and at the main path's 448 x 448), P = 1, 3 and 30, on random masks
    and on masks with obstacles only on the border rows and columns."""
    g = torch.Generator(device=cuda).manual_seed(11)
    h, w = shape
    cap = (r + 1) ** 2 - 1
    for p in (1, 3, 30):
        rand = torch.rand((p, h, w), generator=g, device=cuda) < 0.03
        border = torch.zeros((p, h, w), dtype=torch.bool, device=cuda)
        for sl in ((slice(None), 0), (slice(None), -1),
                   (slice(None), slice(None), 0),
                   (slice(None), slice(None), -1)):
            border[sl] = torch.rand(border[sl].shape, generator=g,
                                    device=cuda) < 0.3
        for m in (rand, border):
            m = m[0] if p == 1 else m
            before = edt_pallas.edt2d.launches
            got = edt_pallas.edt2d(m, cap, r)
            assert edt_pallas.edt2d.launches == before + 1
            assert torch.equal(got, edt_pallas.edt2d_plain(m, cap, r)), \
                (shape, r, p)


def test_edt_kernel_refuses_radius(cuda):
    """Radius 64, the largest halo the tile takes, is served by the tile;
    65 and 255 (R + 1 > 255 for the uint8 |dy|) by the two-launch kernel;
    only a negative radius is refused."""
    g = torch.Generator(device=cuda).manual_seed(12)
    m = torch.rand((100, 130), generator=g, device=cuda) < 0.001
    for r in (64, 65, 255):
        assert torch.equal(edt_pallas.edt2d(m, 65 * 65, r),
                           edt_pallas.edt2d_plain(m, 65 * 65, r)), r
    with pytest.raises(ValueError):
        edt_pallas.edt2d(m, 100, -1)


@pytest.mark.parametrize("r", [65, 100, 254])
@pytest.mark.parametrize("shape", [(448, 448), (61, 203), (3, 300, 301)])
def test_edt_kernel_large_radius(cuda, shape, r):
    """Radii beyond the tile's 64 (up to R + 1 = 255 and past the grid's
    size) on random, border-only and empty masks, P = 1 and 3: bit-equal
    to the plain version, one launch counted."""
    g = torch.Generator(device=cuda).manual_seed(r)
    cap = min((r + 1) ** 2 - 1, 32767)
    border = torch.zeros(shape, dtype=torch.bool, device=cuda)
    border[..., 0, :] = torch.rand(shape[-1], generator=g, device=cuda) < 0.3
    border[..., :, -1] = torch.rand(shape[-2], generator=g, device=cuda) < 0.3
    for m in (torch.rand(shape, generator=g, device=cuda) < 0.002, border,
              torch.zeros(shape, dtype=torch.bool, device=cuda)):
        before = edt_pallas.edt2d.launches
        got = edt_pallas.edt2d(m, cap, r)
        assert edt_pallas.edt2d.launches == before + 1
        assert torch.equal(got, edt_pallas.edt2d_plain(m, cap, r)), shape


def test_batched_edt_kernel_bit_exact(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    dens = torch.tensor([0.0, 0.01, 0.3, 1.0], device=cuda)
    m = torch.rand((4, 448, 448), generator=g, device=cuda) < dens[:, None,
                                                                  None]
    got = edt_pallas.edt2d(m, 100, 10)
    assert got.shape == (4, 448, 448)
    assert torch.equal(got, edt_pallas.edt2d_plain(m, 100, 10))


@pytest.mark.parametrize("p,per_particle", [(1, False), (8, True)])
def test_gn_solve_kernel_matches_plain(cuda, p, per_particle):
    """B4 at Loc2D's shapes (one 576 x 576 window, 768 beams) and with one
    scan per particle: state, iterations, chi2 and SSE bit-equal."""
    (grids, org, st0, pts, mask), kw = _pf_solve_case("cpu", p=p, hw=576,
                                                      seed=7)
    if per_particle:
        g = torch.Generator().manual_seed(8)
        pts = torch.stack([torch.roll(pts, q * 37, 0) for q in range(p)])
        mask = torch.rand((p, pts.shape[1]), generator=g) < 0.9
    args = [t.to(cuda).contiguous() for t in (grids, org, st0, pts, mask)]
    before = gn_solve.solve_window_sq.launches
    got = gn_solve.solve_window_sq(*args, **kw)
    assert gn_solve.solve_window_sq.launches == before + 1
    want = gn_solve.solve_window_sq_plain(*args, **kw)
    assert int(got[1].sum()) >= p
    for name, a, w in zip(("state", "iterations", "chi2", "sum_d2"), got,
                          want):
        assert torch.equal(a, w), (name, a, w)


@pytest.mark.parametrize("b,hw,per_particle,p,staged", [
    (1, 432, False, 3, True),        # one beam: a singular normal matrix
    (255, 432, True, 3, True),
    (257, 432, False, 4, True),      # two threads share a summation lane
    (257, 576, True, 2, False),      # the global-memory variant
    (768, (458, 459), False, 2, True),   # the largest staged at 768 beams
    (768, (459, 459), True, 2, False),   # one row more: global memory
    (768, (431, 433), False, 5, True),   # windows at odd byte offsets
    (1100, 432, False, 2, True),     # two beams a thread, five a lane
    (2048, 432, True, 2, False),     # the most beams the kernel takes
])
def test_gn_solve_kernel_at_edges(cuda, b, hw, per_particle, p, staged):
    """The whole solve at the edges of its design: scans of 1 to 2048
    beams (one to eight a summation lane, shared by up to four threads),
    windows staged in shared memory (up to the largest it takes beside the
    exchange buffer, and at odd offsets, where the copy has a byte head and
    tail) or read from global memory, shared and per-particle scans,
    max_iter 0, 1 and 50, with and without the likelihood: state,
    iterations, chi2 and SSE bit-equal."""
    (grids, org, st0, pts, mask), kw = _pf_solve_case("cpu", p=p, hw=hw,
                                                      b=b, seed=b)
    assert gn_solve.staged(*grids.shape[1:], b) == staged
    if per_particle:
        g = torch.Generator().manual_seed(8)
        pts = torch.stack([torch.roll(pts, q * 37, 0) for q in range(p)])
        mask = torch.rand((p, b), generator=g) < 0.9
    args = [t.to(cuda).contiguous() for t in (grids, org, st0, pts, mask)]
    fn = gn_solve if per_particle else gn_batch
    for max_iter in (0, 1, 50):
        for want_lik in (False, True):
            kw.update(max_iter=max_iter, want_lik=want_lik)
            before = fn.solve_window_sq.launches
            got = fn.solve_window_sq(*args, **kw)
            assert fn.solve_window_sq.launches == before + 1
            want = fn.solve_window_sq_plain(*args, **kw)
            if max_iter == 50 and b > 1:
                assert int(got[1].sum()) >= p   # the starts drive the loop
            for name, a, wv in zip(("state", "iterations", "chi2",
                                    "sum_d2"), got, want):
                assert torch.equal(a, wv), (max_iter, want_lik, name, a, wv)


def test_gn_solve_kernel_refuses_beams(cuda):
    """2049 beams, one past those held in registers, are served (bit-equal
    to the plain version); a mask that does not match the scan is
    refused."""
    args, kw = _pf_solve_case(cuda, p=1, b=2049)
    got = gn_batch.solve_window_sq(*args, **kw)
    want = gn_batch.solve_window_sq_plain(*args, **kw)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    with pytest.raises(ValueError):
        gn_batch.solve_window_sq(*args[:4], args[4][:2048], **kw)


def _widened(t, dtype):
    """An int8 squared-distance tensor as ``dtype``: the same values (an
    exact widening)."""
    return t.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
@pytest.mark.parametrize("per_particle,hw", [(False, 432), (True, 576),
                                             (False, (458, 459))])
def test_gn_solve_kernel_widths(cuda, dtype, per_particle, hw):
    """B4/B6 on uint8, int16 and int32 windows (staged in shared memory
    where they fit beside the exchange buffer, else read from global
    memory), max_iter 0, 1 and 50, with and without the likelihood:
    bit-equal to the plain version, and, on an exact widening of an int8
    window, to the int8 kernel; the launch counted under its width."""
    (grids, org, st0, pts, mask), kw = _pf_solve_case("cpu", p=3, hw=hw,
                                                      seed=21)
    if per_particle:
        g = torch.Generator().manual_seed(22)
        pts = torch.stack([torch.roll(pts, q * 37, 0) for q in range(3)])
        mask = torch.rand((3, pts.shape[1]), generator=g) < 0.9
    args8 = [t.to(cuda).contiguous() for t in (grids, org, st0, pts, mask)]
    args = [_widened(args8[0], dtype), *args8[1:]]
    fn = gn_solve if per_particle else gn_batch
    key = str(dtype).removeprefix("torch.")
    for max_iter in (0, 1, 50):
        for want_lik in (False, True):
            kw.update(max_iter=max_iter, want_lik=want_lik)
            before = fn.solve_window_sq.width_launches.get(key, 0)
            got = fn.solve_window_sq(*args, **kw)
            assert fn.solve_window_sq.width_launches[key] == before + 1
            want = fn.solve_window_sq_plain(*args, **kw)
            ref8 = fn.solve_window_sq(*args8, **kw)
            for a, w, r in zip(got, want, ref8):
                assert torch.equal(a, w) and torch.equal(a, r), \
                    (max_iter, want_lik)


@pytest.mark.parametrize("b", [2049, 3000, 4096])
@pytest.mark.parametrize("per_particle", [False, True])
def test_gn_solve_kernel_beyond_register_beams(cuda, b, per_particle):
    """B4/B6 past the 2,048 beams held in registers (the further beams
    read from global memory each evaluation), on a staged and a global
    window, int8 and int16: bit-equal to the plain version."""
    for hw, dtype in ((432, torch.int8), (576, torch.int16)):
        (grids, org, st0, pts, mask), kw = _pf_solve_case(
            "cpu", p=2, hw=hw, b=b, seed=b)
        if per_particle:
            g = torch.Generator().manual_seed(8)
            pts = torch.stack([torch.roll(pts, q * 37, 0) for q in range(2)])
            mask = torch.rand((2, b), generator=g) < 0.9
        args = [t.to(cuda).contiguous() for t in (grids.to(dtype), org, st0,
                                                  pts, mask)]
        fn = gn_solve if per_particle else gn_batch
        for max_iter in (0, 50):
            kw.update(max_iter=max_iter)
            got = fn.solve_window_sq(*args, **kw)
            want = fn.solve_window_sq_plain(*args, **kw)
            if max_iter == 50:
                assert int(got[1].sum()) >= 2
            for name, a, w in zip(("state", "iterations", "chi2",
                                   "sum_d2"), got, want):
                assert torch.equal(a, w), (hw, dtype, max_iter, name)


@pytest.mark.parametrize("p", [1, 3])
def test_gn_eval_kernel_matches_plain(cuda, p):
    """B5 on one window or three, 768 beams partly off the window."""
    g = torch.Generator().manual_seed(9)
    h = w = 576
    grid = torch.randint(0, 101, (p, h, w), generator=g, dtype=torch.int8)
    ly = torch.randint(-3, h + 3, (p, 768), generator=g, dtype=torch.int32)
    lx = torch.randint(-3, w + 3, (p, 768), generator=g, dtype=torch.int32)
    fl = [torch.rand((p, 768), generator=g) for _ in range(4)]
    fm = (torch.rand((p, 768), generator=g) < 0.9).float()
    args = [t.to(cuda) for t in (grid, ly, lx, *fl, fm)]
    for cauchy_c in (0.15, 0.0):
        kw = dict(max_dist=0.5, res=0.05, scale=20.0, cauchy_c=cauchy_c)
        before = match_eval.gn_eval_sq.launches
        got = match_eval.gn_eval_sq(*args, **kw)
        assert match_eval.gn_eval_sq.launches == before + 1
        assert torch.equal(got, match_eval.gn_eval_sq_plain(*args, **kw))


def _eval_case(dev, p, b, seed, masked=False):
    """B5's operands: p int8 windows 431 x 433 (the same bytes also at an
    odd byte offset), cells up to 3 off the window on every side (beams 0-3
    on its edges), fractions, hits within 10 m and 90% of the beams kept
    (none when ``masked``), as the [p, b, 2] cell / fraction / hit tensors
    of the fused loop. Returns (grids, (loc, mu, hits, fm))."""
    g = torch.Generator().manual_seed(seed)
    h, w = 431, 433
    grid = torch.randint(0, 101, (p, h, w), generator=g, dtype=torch.int8)
    ly = torch.randint(-3, h + 3, (p, b), generator=g, dtype=torch.int32)
    lx = torch.randint(-3, w + 3, (p, b), generator=g, dtype=torch.int32)
    for i, (y, x) in enumerate(((-1, 5), (h - 1, 7), (9, -1), (11, w - 1))):
        if i < b:
            ly[:, i], lx[:, i] = y, x
    loc = torch.stack([lx, ly], -1)
    mu = torch.rand((p, b, 2), generator=g)
    hits = (torch.rand((p, b, 2), generator=g) - 0.5) * 20.0
    fm = torch.zeros((p, b)) if masked else \
        (torch.rand((p, b), generator=g) < 0.9).float()
    buf = torch.empty(p * h * w + 1, dtype=torch.int8)
    buf[1:] = grid.flatten()
    odd = buf.to(dev)[1:].view(p, h, w)
    assert odd.data_ptr() % 2 == 1
    return (grid.to(dev), odd), tuple(t.to(dev) for t in (loc, mu, hits, fm))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("b", [1, 255, 257, 768, 1100, 2048])
def test_gn_eval_kernel_at_edges(cuda, b, p, masked):
    """B5 at the edges of its design — 1 to 2048 beams (one to eight a
    summation lane, shared by up to four threads), one window or three
    (P = 1 through the unbatched entry point), cells off the window on
    every side, an all-masked scan — with contiguous operands and with the
    strided views the fused loop passes, on a grid at an even and at an odd
    byte offset, unit and Cauchy weights: bit-equal to the plain
    version."""
    grids, (loc, mu, hits, fm) = _eval_case(cuda, p, b, b + p, masked)
    views = (loc[..., 1], loc[..., 0], mu[..., 0], mu[..., 1], hits[..., 0],
             hits[..., 1], fm)
    for ops in (views, [v.contiguous() for v in views]):
        for grid in grids:
            for cauchy_c in (0.15, 0.0):
                kw = dict(max_dist=0.5, res=0.05, scale=20.0,
                          cauchy_c=cauchy_c)
                args = (grid, *ops) if p > 1 else \
                    (grid[0], *(t[0] for t in ops))
                before = match_eval.gn_eval_sq.launches
                got = match_eval.gn_eval_sq(*args, **kw)
                assert match_eval.gn_eval_sq.launches == before + 1
                want = match_eval.gn_eval_sq_plain(*args, **kw)
                assert torch.equal(got, want), (cauchy_c, got, want)
                if masked:
                    assert not got.any()


def test_gn_eval_kernel_reads_expanded_operands(cuda):
    """Operands with a stride of 0 — one mask expanded over the particles,
    one fraction expanded over the beams — are read as they stand."""
    grids, (loc, mu, hits, fm) = _eval_case(cuda, 3, 768, 5)
    mux = mu[:, :1, 0].expand(3, 768)
    fmx = fm[0].expand(3, 768)
    assert mux.stride()[1] == 0 and fmx.stride()[0] == 0
    args = (grids[0], loc[..., 1], loc[..., 0], mux, mu[..., 1],
            hits[..., 0], hits[..., 1], fmx)
    kw = dict(max_dist=0.5, res=0.05, scale=20.0, cauchy_c=0.15)
    got = match_eval.gn_eval_sq(*args, **kw)
    assert torch.equal(got, match_eval.gn_eval_sq_plain(
        *(t.contiguous() for t in args), **kw))


def test_gn_eval_kernel_refuses_beams(cuda):
    """2049 beams, one past those held in registers, are served (bit-equal
    to the plain version); operands of unequal length are refused."""
    grids, (loc, mu, hits, fm) = _eval_case(cuda, 1, 2049, 6)
    ops = (loc[0, :, 1], loc[0, :, 0], mu[0, :, 0], mu[0, :, 1],
           hits[0, :, 0], hits[0, :, 1], fm[0])
    kw = dict(max_dist=0.5, res=0.05, scale=20.0, cauchy_c=0.15)
    assert torch.equal(match_eval.gn_eval_sq(grids[0][0], *ops, **kw),
                       match_eval.gn_eval_sq_plain(grids[0][0], *ops, **kw))
    with pytest.raises(ValueError):
        match_eval.gn_eval_sq(grids[0][0], *ops[:6], fm[0, :2048], **kw)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
@pytest.mark.parametrize("p", [1, 3])
def test_gn_eval_kernel_widths(cuda, dtype, p):
    """B5 on uint8, int16 and int32 windows (an exact widening of an
    int8 one, and the type's full range), strided views, unit and Cauchy
    weights: bit-equal to the plain version and, on the widening, to the
    int8 kernel; the launch counted under its width."""
    grids, (loc, mu, hits, fm) = _eval_case(cuda, p, 768, 40 + p)
    views = (loc[..., 1], loc[..., 0], mu[..., 0], mu[..., 1], hits[..., 0],
             hits[..., 1], fm)
    hi = torch.iinfo(dtype).max
    g = torch.Generator().manual_seed(41)
    full = torch.randint(0, hi, grids[0].shape, generator=g).to(dtype)
    key = str(dtype).removeprefix("torch.")
    for grid8, grid in ((grids[0], _widened(grids[0], dtype)),
                        (None, full.to(cuda))):
        for cauchy_c in (0.15, 0.0):
            kw = dict(max_dist=0.5, res=0.05, scale=20.0, cauchy_c=cauchy_c)
            args = (grid, *views) if p > 1 else \
                (grid[0], *(t[0] for t in views))
            before = match_eval.gn_eval_sq.width_launches.get(key, 0)
            got = match_eval.gn_eval_sq(*args, **kw)
            assert match_eval.gn_eval_sq.width_launches[key] == before + 1
            assert torch.equal(got, match_eval.gn_eval_sq_plain(*args, **kw))
            if grid8 is not None:
                a8 = (grid8, *args[1:]) if p > 1 else (grid8[0], *args[1:])
                assert torch.equal(got, match_eval.gn_eval_sq(*a8, **kw))


@pytest.mark.parametrize("b", [2049, 3000, 4096])
@pytest.mark.parametrize("p", [1, 3])
def test_gn_eval_kernel_beyond_register_beams(cuda, b, p):
    """B5 past the 2,048 beams held in registers, int8 and int32, strided
    views and contiguous operands: bit-equal to the plain version."""
    grids, (loc, mu, hits, fm) = _eval_case(cuda, p, b, b + p)
    views = (loc[..., 1], loc[..., 0], mu[..., 0], mu[..., 1], hits[..., 0],
             hits[..., 1], fm)
    kw = dict(max_dist=0.5, res=0.05, scale=20.0, cauchy_c=0.15)
    for grid in (grids[0], _widened(grids[0], torch.int32)):
        for ops in (views, [v.contiguous() for v in views]):
            args = (grid, *ops) if p > 1 else (grid[0], *(t[0] for t in ops))
            assert torch.equal(match_eval.gn_eval_sq(*args, **kw),
                               match_eval.gn_eval_sq_plain(*args, **kw))


@pytest.mark.parametrize("w", [488, 489, 490, 491])    # w % 4: 0, 1, 2, 3
def test_select4_kernel_at_edges(cuda, w):
    """B2 on grids whose rows end at every offset within a 32-bit word, at
    byte offsets 0-3, with cells in and around the last column and row,
    and indices contiguous, as the interleaved columns of a [B, 2] tensor
    and as columns of a [B, 3] one: bit-equal to the plain version."""
    g = torch.Generator().manual_seed(w)
    h, b = 37, 777
    buf = torch.randint(-128, 128, (h * w + 3,), generator=g,
                        dtype=torch.int8).to(cuda)
    ly = torch.randint(-3, h + 3, (b,), generator=g, dtype=torch.int32)
    lx = torch.randint(-3, w + 3, (b,), generator=g, dtype=torch.int32)
    edge = torch.tensor([[h - 1, w - 1], [h - 1, w - 2], [h - 2, w - 1],
                         [h, w], [-1, w - 1], [h - 1, -1], [0, 0],
                         [h - 1, w - 3], [h - 1, w - 4]], dtype=torch.int32)
    ly[:len(edge)], lx[:len(edge)] = edge[:, 0], edge[:, 1]
    pair = torch.stack([lx, ly], -1).to(cuda)
    wide = torch.stack([ly, ly, lx], -1).to(cuda)
    layouts = ((ly.to(cuda), lx.to(cuda)), (pair[:, 1], pair[:, 0]),
               (wide[:, 0], wide[:, 2]))
    for off in range(4):
        grid = buf[off:off + h * w].view(h, w)
        for iy, ix in layouts:
            before = select4.select4_sq.launches
            got = select4.select4_sq(grid, iy, ix)
            assert select4.select4_sq.launches == before + 1
            want = select4.select4_sq_plain(grid, iy, ix)
            assert torch.equal(got, want), (off, iy.stride())


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
def test_select4_kernel_widths(cuda, dtype):
    """B2 on uint8, int16 and int32 grids over the type's whole range
    (uint8 read unsigned, the others signed), cells around every edge,
    contiguous and strided indices: bit-equal to the plain version."""
    g = torch.Generator().manual_seed(30)
    info = torch.iinfo(dtype)
    h, w, b = 489, 491, 777
    grid = torch.randint(info.min, info.max, (h, w), generator=g,
                         dtype=torch.int64).to(dtype).to(cuda)
    cells = torch.stack([torch.randint(-3, w + 3, (b,), generator=g),
                         torch.randint(-3, h + 3, (b,), generator=g)],
                        -1).to(torch.int32).to(cuda)
    key = str(dtype).removeprefix("torch.")
    for ly, lx in ((cells[:, 1], cells[:, 0]),
                   (cells[:, 1].contiguous(), cells[:, 0].contiguous())):
        before = select4.select4_sq.width_launches.get(key, 0)
        got = select4.select4_sq(grid, ly, lx)
        assert select4.select4_sq.width_launches[key] == before + 1
        assert torch.equal(got, select4.select4_sq_plain(grid, ly, lx))


@pytest.mark.parametrize("rays,steps", [(768, 202), (100, 203), (33, 1)])
@pytest.mark.parametrize("p", [1, 3])
def test_deposit_kernel_ragged_streams(cuda, rays, steps, p):
    """B1 on raycast-like streams (neighbouring rays share cells near the
    sensor) of a whole number of the kernel's 512-element blocks (Slam2D's
    768 x 202) and of ragged lengths, beam-major, shuffled and with
    sentinels, one particle and three: bit-equal to the plain version, one
    launch counted."""
    g = torch.Generator(device=cuda).manual_seed(rays + steps + p)
    h = w = 448
    t = torch.arange(steps, device=cuda)
    ang = torch.rand((p, rays, 1), generator=g, device=cuda) * 0.3
    y = (200 + torch.sin(ang) * t).to(torch.int32)     # rays fan out
    x = (224 + torch.cos(ang) * t * 1.7 - 150).to(torch.int32)
    ly, lx = y.reshape(p, -1), x.reshape(p, -1)
    n = rays * steps
    perm = torch.randperm(n, device=cuda)
    sent = torch.rand((p, n), generator=g, device=cuda) < 0.3
    for cly, clx in ((ly, lx),
                     (ly[:, perm].contiguous(), lx[:, perm].contiguous()),
                     (torch.where(sent, h, ly).contiguous(), lx)):
        a, b = (cly[0], clx[0]) if p == 1 else (cly, clx)
        before = scatter_matmul.deposit_counts.launches
        got = scatter_matmul.deposit_counts(a, b, h, w)
        assert scatter_matmul.deposit_counts.launches == before + 1
        assert torch.equal(got, scatter_matmul.deposit_counts_plain(a, b, h,
                                                                    w))


@pytest.mark.parametrize("rays,steps", [(768, 202), (100, 203)])
@pytest.mark.parametrize("p", [1, 3, 30])
def test_deposit_pair_kernel(cuda, rays, steps, p):
    """The pair (hits into occ and vis, free cells into vis, one memset
    and one launch) on random streams with out-of-grid elements, ragged
    lengths, one to 30 particles: bit-equal to two plain deposits and an
    add; particles of mismatched streams are refused."""
    g = torch.Generator(device=cuda).manual_seed(p + steps)
    h = w = 448

    def stream(n):
        ly = torch.randint(-4, h + 4, (p, n), generator=g, device=cuda,
                           dtype=torch.int32)
        lx = torch.randint(100, 140, (p, n), generator=g, device=cuda,
                           dtype=torch.int32)
        return (ly[0], lx[0]) if p == 1 else (ly, lx)

    hit, free = stream(rays), stream(rays * steps)
    before = scatter_matmul.deposit_pair.launches
    got = scatter_matmul.deposit_pair(*hit, *free, h, w)
    assert scatter_matmul.deposit_pair.launches == before + 1
    want = scatter_matmul.deposit_pair_plain(*hit, *free, h, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if p > 1:
        with pytest.raises(ValueError):
            scatter_matmul.deposit_pair(*hit, free[0][:1].contiguous(),
                                        free[1][:1].contiguous(), h, w)


def test_value_scatters_match_plain(cuda):
    """B7 and B8 on ~21 k elements into [448, 512], with duplicates."""
    g = torch.Generator(device=cuda).manual_seed(10)
    h, w, n = 448, 512, 21000
    ly = torch.randint(0, h, (n,), generator=g, device=cuda,
                       dtype=torch.int32)
    lx = torch.randint(0, w, (n,), generator=g, device=cuda,
                       dtype=torch.int32)
    ly[: n // 4], lx[: n // 4] = 7, 9
    val = torch.randint(-5, 6, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    assert torch.equal(scatter_pallas.scatter_add_2d(ly, lx, val, (h, w)),
                       scatter_pallas.scatter_add_2d_plain(ly, lx, val,
                                                           (h, w)))
    bits = val.remainder(2)
    packed = scatter_sorted.pack_updates(ly, lx, bits)
    got = scatter_sorted.scatter_add_sorted(packed, (h, w))
    assert torch.equal(got, scatter_sorted.scatter_add_sorted_plain(packed,
                                                                    (h, w)))
    assert torch.equal(got, scatter_pallas.scatter_add_2d_plain(ly, lx, bits,
                                                                (h, w)))


@pytest.mark.parametrize("mode", ["solve", "fused"])
def test_loc2d_on_card_matches_cpu(cuda, mode):
    """Loc2D on a small Slam2D map (built on the CPU, carried to both
    devices as numpy): the same accepted scans, poses within 1 mm / 1e-3
    rad, and the mode's kernel launched on the card."""
    data = simulator.simulate(simulator.SimConfig(
        n_steps=40, seed=4,
        laser=simulator.LaserSpec(n_beams=120, max_range=8.0)))
    sopts = Slam2DOptions(resolution=0.1, patch_size=16, max_range=8.0,
                          trans_thresh=0.2, rot_thresh=0.2, capacity=1024)
    slam = Slam2D(sopts, device="cpu")
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    for k in range(40):
        slam.update(data.clouds[k], data.odometry[k])
    maps_np = state.locmaps_to_numpy(loc2d.maps_from_slam(slam.map, None))
    fn = (gn_solve.solve_window_sq if mode == "solve"
          else match_eval.gn_eval_sq)
    before = (fn.launches, select4.select4_sq.launches)
    runs = []
    for dev in ("cpu", cuda):
        loc = loc2d.Loc2D(loc2d.Loc2DOptions(resolution=0.1, l2_max=0.5,
                                             max_range=8.0, trans_thresh=0.2,
                                             rot_thresh=0.2),
                          maps=state.locmaps_from_numpy(maps_np, dev),
                          device=dev, match=mode)
        loc.set_prior(Pose2D(*data.poses_gt[0]))
        acc = [k for k in range(40)
               if loc.update(data.clouds[k], data.odometry[k])]
        runs.append((acc, loc.trajectory()))
    (acc_c, tc), (acc_g, tg) = runs
    assert acc_c == acc_g and len(acc_c) > 10
    assert np.abs(tc[:, :2] - tg[:, :2]).max() <= 1e-3
    assert np.abs(np.angle(np.exp(1j * (tc[:, 2] - tg[:, 2])))).max() <= 1e-3
    assert fn.launches > before[0] and select4.select4_sq.launches > before[1]


def test_pf_on_card_matches_cpu(cuda):
    """A short PF run (8 particles, the CPU tests' config) on the card and
    on the CPU with the same seed: the same draws, poses within 1 mm /
    1e-3 rad, equal lineage, and B1, B3 and B6 launched on the card."""
    data = simulator.simulate(simulator.SimConfig(
        n_steps=60, seed=2,
        laser=simulator.LaserSpec(n_beams=120, max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))
    opts = PFSlam2DOptions(particles=8, resolution=0.1, patch_size=16,
                           max_range=8.0, capacity=1024, trans_thresh=0.3,
                           rot_thresh=0.3, max_iter=30, seed=3,
                           meas_sigma_gain=1.0, resident_extra_patches=2,
                           host_reorg_slack=0.5)
    padded = [pad_scan(c, beam_bucket(120)) for c in data.clouds[:11]]
    fns = (scatter_matmul.deposit_pair, edt_pallas.edt2d,
           gn_batch.solve_window_sq)
    before = [f.launches for f in fns]
    runs = []
    for dev in ("cpu", cuda):
        pf = PFSlam2D(opts, device=dev)
        pf.set_prior(Pose2D(*data.poses_gt[0]))
        staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
                  for p in padded]
        acc = pf.update_many_prepadded(staged, data.odometry[:11])
        runs.append((acc, pf.pset.pose.cpu().numpy(),
                     pf.pset.lineage.cpu().numpy(), pf.n_reorgs,
                     pf.escaped_count()))
    (acc_c, pc, lc, rc, ec), (acc_g, pg, lg, rg, eg) = runs
    assert acc_c == acc_g and rc == rg >= 1 and ec == eg == 0
    assert np.abs(pc[:, :2] - pg[:, :2]).max() <= 1e-3
    dth = np.angle(np.exp(1j * (np.arctan2(pc[:, 3], pc[:, 2])
                                - np.arctan2(pg[:, 3], pg[:, 2]))))
    assert np.abs(dth).max() <= 1e-3
    assert np.array_equal(lc, lg)
    assert all(f.launches > b for f, b in zip(fns, before))


# ---------------------------------------------------------------------------
# LidarOdometry2D and Slam2D's transient and pool-per-scan maps
# ---------------------------------------------------------------------------

def _lo_scan_streams(dev):
    """LidarOdometry2D's deposit streams of a real 720-beam 5 cm scan into
    its 640 x 640 window (1 m rays: 22 steps)."""
    from iris_lama_tpu_torch.algos.lidar_odometry_2d import (
        LidarOdometry2DOptions)
    from iris_lama_tpu_torch.core import lie
    from iris_lama_tpu_torch.sdm import mapping, window
    data = simulator.simulate(simulator.SimConfig(
        n_steps=200, seed=3, smooth=4,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    cfg = LidarOdometry2DOptions(capacity=64).mapping_config()
    pts, msk, ori = (torch.as_tensor(a, device=dev)
                     for a in pad_scan(data.clouds[0], beam_bucket(720)))
    pose = lie.se2(0.0, 0.0, 0.0, device=dev)
    org = window.window_org(cfg.geometry, cfg.geometry.w2m(pose[:2]),
                            cfg.window_patches)
    return cfg, mapping.deposit_indices(cfg, pose, pts, msk, ori, org,
                                        cfg.window_cells)


def test_lo_deposit_pair_and_edt_kernels(cuda):
    """B1's pair at [2, 640, 640] with 22-step rays and B3 at 640^2, R =
    20, cap 400 (squared distances past a byte) on a real scan's window:
    bit-equal to the plain versions."""
    from iris_lama_tpu_torch.sdm.occupancy import probabilistic_saturate
    cfg, idx = _lo_scan_streams(cuda)
    w = cfg.window_cells
    assert (w, cfg.ray_steps, cfg.distance.radius_cells) == (640, 22, 20)
    args = (idx.hit_ly, idx.hit_lx, idx.free_ly, idx.free_lx, w, w)
    got = scatter_matmul.deposit_pair(*args)
    want = scatter_matmul.deposit_pair_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    obst = probabilistic_saturate(torch.zeros((w, w), device=cuda), got[0],
                                  got[1] - got[0]) > 0.0
    cap, r = cfg.distance.max_sqdist, cfg.distance.radius_cells
    g = torch.Generator(device=cuda).manual_seed(20)
    for m in (obst, torch.rand((w, w), generator=g, device=cuda) < 0.01):
        d = edt_pallas.edt2d(m, cap, r)
        assert torch.equal(d, edt_pallas.edt2d_plain(m, cap, r))
    assert int(edt_pallas.edt2d(obst, cap, r).max()) == cap == 400


def test_lidar_odometry_on_card_matches_cpu(cuda):
    """20 scans of the CPU tests' config on the card and on the CPU: poses
    within 1 mm / 1e-3 rad, the same refresh decisions and patch counts,
    B1 and B3 launched on the card."""
    from iris_lama_tpu_torch.algos.lidar_odometry_2d import (
        LidarOdometry2D, LidarOdometry2DOptions)
    data = simulator.simulate(simulator.SimConfig(
        n_steps=200, seed=13,
        laser=simulator.LaserSpec(n_beams=120, max_range=6.0)))
    opts = LidarOdometry2DOptions(resolution=0.1, patch_size=16,
                                  max_range=6.0, capacity=2048)
    padded = [pad_scan(c, beam_bucket(120)) for c in data.clouds[:20]]
    before = (scatter_matmul.deposit_pair.launches,
              edt_pallas.edt2d.launches)
    runs = []
    for dev in ("cpu", cuda):
        lo = LidarOdometry2D(opts, device=dev)
        flags, patches = [], []
        for p in padded:
            lo.update_prepadded(*(torch.as_tensor(a, device=dev) for a in p))
            flags.append(lo.last_refresh)
            patches.append(int(lo.map.table.num_patches()))
        runs.append((lo.trajectory(), flags, patches))
    (tc, fc, pc), (tg, fg, pg) = runs
    assert fc == fg and pc == pg
    assert np.abs(tc[:, :2] - tg[:, :2]).max() <= 1e-3
    assert np.abs(np.angle(np.exp(1j * (tc[:, 2] - tg[:, 2])))).max() <= 1e-3
    after = (scatter_matmul.deposit_pair.launches, edt_pallas.edt2d.launches)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.parametrize("kw", [dict(transient_map=True),
                                dict(resident_window=False)],
                         ids=["transient", "pool"])
def test_slam2d_options_on_card_match_cpu(cuda, kw, monkeypatch):
    """Slam2D's transient map and pool-per-scan path over the first 30
    scans of bench.py's workload (720 beams, 5 cm) on the card and on the
    CPU: the same accepted scans, poses within 1 mm, and B1, B2 and B3
    launched on the card. Then the card again, its scan matches replaced
    by the CPU run's poses: the pool (tables and cell arrays) bit-equal to
    the CPU's. (Free-running, an ulp of pose may move a ray's cell, and
    with it a patch in or out of a transient map; on the small 0.1 m,
    120-beam config, whose 2.7 m steps track to 0.25 m, that grows into a
    different trajectory.)"""
    from iris_lama_tpu_torch.match import match_surface_2d
    from iris_lama_tpu_torch.nlls.solver import SolveResult
    data = simulator.simulate(simulator.SimConfig(
        n_steps=440, seed=3,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    opts = Slam2DOptions(resolution=0.05, max_range=10.0, trans_thresh=0.05,
                         rot_thresh=0.05, capacity=8192, max_iter=50, **kw)
    padded = [pad_scan(c, beam_bucket(720)) for c in data.clouds[:30]]
    before = (scatter_matmul.deposit_pair.launches,
              select4.select4_sq.launches, edt_pallas.edt2d.launches)

    def run(dev):
        slam = Slam2D(opts, device=dev)
        slam.set_prior(Pose2D(*data.poses_gt[0]))
        staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
                  for p in padded]
        acc = slam.update_many_prepadded(staged, data.odometry[:30])
        return acc, slam

    (acc_c, cpu), (acc_g, gpu) = run("cpu"), run(cuda)
    tc, tg = cpu.trajectory(), gpu.trajectory()
    assert acc_c == acc_g and len(acc_c) > 10
    assert np.abs(tc[:, :2] - tg[:, :2]).max() <= 1e-3
    after = (scatter_matmul.deposit_pair.launches,
             select4.select4_sq.launches, edt_pallas.edt2d.launches)
    assert all(a > b for a, b in zip(after, before))

    poses = iter(cpu._traj[1:len(acc_c)].to(cuda))

    def forced(*args, **kwargs):
        zero = torch.zeros((), device=cuda)
        return SolveResult(next(poses), torch.zeros((), dtype=torch.int32,
                                                    device=cuda),
                           zero, zero, zero)

    monkeypatch.setattr(match_surface_2d, "solve_window", forced)
    acc_f, forced_run = run(cuda)
    assert acc_f == acc_c
    want, got = state.map_to_numpy(cpu.map), state.map_to_numpy(
        forced_run.map)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _graph_key_scans(dev, n_keys=8):
    """Padded 720-beam scans of bench_graph.py's workload at key-pose
    spacing, with their true poses, on ``dev``."""
    data = simulator.simulate(simulator.SimConfig(
        n_steps=8 * n_keys, seed=8,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    ks = range(0, 8 * n_keys, 8)
    scans = [pad_scan(data.clouds[k], beam_bucket(720)) for k in ks]
    g = [data.poses_gt[k] for k in ks]
    poses = np.asarray([[p[0], p[1], np.cos(p[2]), np.sin(p[2])] for p in g],
                       np.float32)
    return tuple(torch.as_tensor(np.stack(a), device=dev)
                 for a in (poses, *zip(*scans)))


def test_rebuild_deposit_pair_kernel(cuda):
    """B1's pair over all key-pose scans at once into the rebuild grid
    (millions of elements, a grid that is not square): bit-equal to its
    plain version, and the rebuild (counts, meters) equal on both
    devices."""
    from iris_lama_tpu_torch.parallel import map_rebuild
    cfg = Slam2DOptions(resolution=0.05, max_range=10.0,
                        capacity=4 * 4096).mapping_config()
    poses, pts, msk, ori = _graph_key_scans(cuda)
    org, h, w = map_rebuild.grid_bounds(cfg, cfg.geometry,
                                        poses.cpu().numpy())
    assert h != w
    (hy, hx), (fy, fx) = map_rebuild._scan_cells(
        cfg, poses, pts, msk, ori,
        torch.as_tensor(org, dtype=torch.int32, device=cuda), h, w)
    assert fy.numel() > 1_000_000
    got = scatter_matmul.deposit_pair(hy, hx, fy, fx, h, w)
    want = scatter_matmul.deposit_pair_plain(hy, hx, fy, fx, h, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    dense = [map_rebuild.rebuild_dense(cfg, *(t.to(dev) for t in (
        poses, pts, msk, ori)), org, h, w) for dev in ("cpu", cuda)]
    for f in ("occ", "vis", "dist"):
        assert torch.equal(getattr(dense[0], f), getattr(dense[1], f).cpu())


@pytest.mark.parametrize("shape,r", [((4, 116, 116), 10),
                                     ((368, 464), 50), ((768, 992), 10)],
                         ids=["coarse_p4", "r50", "rebuild"])
def test_graph_edt_shapes(cuda, shape, r):
    """B3 at the graph path's shapes: the coarse fallback's batch, the
    coarse distance map's R = 50 (cap 2,500) and the rebuild grid, none a
    multiple of the 32 x 64 tile: bit-equal to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(r)
    for dens in (0.001, 0.02, 0.3):
        m = torch.rand(shape, generator=g, device=cuda) < dens
        assert torch.equal(edt_pallas.edt2d(m, r * r, r),
                           edt_pallas.edt2d_plain(m, r * r, r))


def _graph_opts():
    from iris_lama_tpu_torch.algos.graph_slam2d import GraphSlam2DOptions
    return GraphSlam2DOptions(
        slam=Slam2DOptions(resolution=0.05, max_range=10.0,
                           trans_thresh=0.25, rot_thresh=0.25,
                           capacity=4096, transient_map=True),
        ignore_n_chain_poses=10, key_pose_head_delay=3,
        loop_closure_scan_rmse=0.12)


def test_graph_slam_on_card_matches_cpu(cuda):
    """The first 40 scans of bench_graph.py's workload through the per-scan
    GraphSlam2D path on the card and on the CPU: the same key-pose update
    indices, key poses within 1 mm / 1e-3 rad, B1, B2 and B3 launched."""
    from iris_lama_tpu_torch.algos.graph_slam2d import GraphSlam2D
    data = simulator.simulate(simulator.SimConfig(
        n_steps=40, seed=8,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))
    padded = [pad_scan(c, beam_bucket(720)) for c in data.clouds]
    before = (scatter_matmul.deposit_pair.launches,
              select4.select4_sq.launches, edt_pallas.edt2d.launches)
    runs = []
    for dev in ("cpu", cuda):
        gs = GraphSlam2D(_graph_opts(), device=dev)
        gs.set_prior(Pose2D(*data.poses_gt[0]))
        for k, p in enumerate(padded):
            gs.update_prepadded(*p, data.odometry[k], float(k))
        runs.append(gs.key_poses)
    kc, kg = runs
    assert [k.timestamp for k in kc] == [k.timestamp for k in kg]
    pc = np.asarray([k.pose.xyr() for k in kc])
    pg = np.asarray([k.pose.xyr() for k in kg])
    assert np.abs(pc[:, :2] - pg[:, :2]).max() <= 1e-3
    assert np.abs(np.angle(np.exp(1j * (pc[:, 2] - pg[:, 2])))).max() <= 1e-3
    after = (scatter_matmul.deposit_pair.launches,
             select4.select4_sq.launches, edt_pallas.edt2d.launches)
    assert all(a > b for a, b in zip(after, before))


def test_graph_verification_batch_on_both_devices(cuda):
    """One verification batch (the last key pose against the five before
    it) from one state carried to both devices: states and errors within
    1e-5."""
    from iris_lama_tpu_torch.algos.graph_slam2d import GraphSlam2D
    data = simulator.simulate(simulator.SimConfig(
        n_steps=40, seed=8,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))
    gs = GraphSlam2D(_graph_opts(), device=cuda)
    gs.set_prior(Pose2D(*data.poses_gt[0]))
    for k, c in enumerate(data.clouds):
        gs.update(c, data.odometry[k], float(k))
    n = len(gs.key_poses)                     # drains the verifications
    d = state.graph_to_numpy(gs)
    assert n >= 6
    rows = [(n - 1, c) for c in range(n - 6, n - 1)]
    packed = []
    for dev in ("cpu", cuda):
        g = GraphSlam2D(_graph_opts(), device=dev)
        state.graph_from_numpy(g, d)
        corr, _, _ = g._programs()
        kps = g._key_poses
        cand = np.stack([kps[c].pose.se2_array() for _, c in rows])
        hyp = np.stack([Pose2D(kps[q].pose.x(), kps[q].pose.y(),
                               kps[c].pose.rotation()).se2_array()
                        for q, c in rows])
        packed.append(corr(g.slam.map, torch.as_tensor(cand, device=dev),
                           torch.as_tensor(hyp, device=dev),
                           torch.stack([kps[c].points[:, :2]
                                        for _, c in rows]),
                           torch.stack([kps[c].mask for _, c in rows]))
                      .cpu().numpy())
    np.testing.assert_allclose(packed[1], packed[0], atol=1e-5)


# ---------------------------------------------------------------------------
# Maps on disk and the PF pool path
# ---------------------------------------------------------------------------

def _scan_cells(dev, seed):
    """A 720-beam 5 cm scan's hit and free cells (duplicates included) and
    their counts, as the map update derives them."""
    from iris_lama_tpu_torch.core import lie
    from iris_lama_tpu_torch.sdm import mapping
    data = simulator.simulate(simulator.SimConfig(
        n_steps=4, seed=seed,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    cfg = Slam2DOptions(capacity=256).mapping_config()
    pts, msk, ori = (torch.as_tensor(a, device=dev)
                     for a in pad_scan(data.clouds[0], beam_bucket(720)))
    pose = lie.se2(*data.poses_gt[0], device=dev)
    idx = mapping.deposit_indices(cfg, pose, pts, msk, ori,
                                  torch.zeros(2, dtype=torch.int32,
                                              device=dev), 1 << 20)
    hit = torch.stack([idx.hit_lx, idx.hit_ly], -1)
    free = torch.stack([idx.free_lx, idx.free_ly], -1)
    cells = torch.cat([hit, free])
    ok = cells[:, 1] < (1 << 20)
    cells = cells[ok]
    n_hit = int(ok[:hit.shape[0]].sum())
    hits = (torch.arange(cells.shape[0], device=dev) < n_hit).to(torch.int32)
    return cfg.geometry, cells, hits


def test_occupancy_apply_on_card_equals_cpu(cuda):
    """frequency_apply_counts and probabilistic_apply on a scan's cells:
    the card's states equal the CPU's."""
    from iris_lama_tpu_torch.sdm import occupancy as occ
    geo, cells, hits = _scan_cells(cuda, 3)
    out = []
    for dev in ("cpu", cuda):
        cfg = occ.OccupancyConfig(geo, 256)
        c, h = cells.to(dev), hits.to(dev)
        f = occ.frequency_apply_counts(occ.frequency_init(cfg, dev), geo, c,
                                       h, torch.ones_like(h))
        p = occ.probabilistic_apply(occ.probabilistic_init(cfg, dev), geo, c,
                                    h, 1 - h)
        out.append([t.cpu() for t in (*f.table, f.occupied, f.visited,
                                      *p.table, p.logodds, p.touched)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_smd_round_trip_on_card(cuda, tmp_path):
    """A Slam2D map built on the card written as .smd, read back onto the
    card and written again: the same bytes, and the same bytes as written
    from the map moved to the CPU."""
    from iris_lama_tpu_torch.sdm import io as sdm_io
    data = simulator.simulate(simulator.SimConfig(
        n_steps=30, seed=4, laser=simulator.LaserSpec(n_beams=120,
                                                      max_range=8.0)))
    slam = Slam2D(Slam2DOptions(resolution=0.1, patch_size=16,
                                max_range=8.0, capacity=1024), device=cuda)
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    for k in range(30):
        slam.update(data.clouds[k], data.odometry[k])
    m = slam.map
    host = state.map_from_numpy(state.map_to_numpy(m), "cpu")
    geo, l2 = slam.cfg.geometry, slam.cfg.l2_max
    for kind, mm in (("f", m), ("fc", host)):
        sdm_io.write_frequency_occupancy(mm, geo, str(tmp_path / f"{kind}"))
        sdm_io.write_distance_map(mm, geo, l2, str(tmp_path / f"{kind}.d"))
    assert (tmp_path / "f").read_bytes() == (tmp_path / "fc").read_bytes()
    assert (tmp_path / "f.d").read_bytes() == (tmp_path / "fc.d").read_bytes()
    freq, g2 = sdm_io.read_frequency_occupancy(str(tmp_path / "f"), 1024,
                                               device=cuda)
    dm, dcfg = sdm_io.read_distance_map(str(tmp_path / "f.d"), 1024,
                                        device=cuda)
    assert freq.occupied.is_cuda and dm.dist.is_cuda
    sdm_io.write_frequency_occupancy(freq, g2, str(tmp_path / "f2"))
    sdm_io.write_distance_map(dm, dcfg.geometry, l2, str(tmp_path / "f2.d"))
    assert (tmp_path / "f2").read_bytes() == (tmp_path / "f").read_bytes()
    assert (tmp_path / "f2.d").read_bytes() == (tmp_path / "f.d").read_bytes()


def test_pf_pool_path_on_card_matches_cpu(cuda):
    """The PF pool path (``resident_window=False``) on the card and on the
    CPU with the same seed, on test_pf_on_card_matches_cpu's run: the same
    accepted scans and resample decisions, poses within 1 mm / 1e-3 rad;
    on the card it equals the resident path bit for bit (as on the CPU),
    and B1's pair, B3 and B6 launched."""
    import dataclasses
    data = simulator.simulate(simulator.SimConfig(
        n_steps=60, seed=2,
        laser=simulator.LaserSpec(n_beams=120, max_range=8.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))
    opts = PFSlam2DOptions(particles=8, resolution=0.1, patch_size=16,
                           max_range=8.0, capacity=1024, trans_thresh=0.3,
                           rot_thresh=0.3, max_iter=30, seed=3,
                           meas_sigma_gain=1.0, resident_extra_patches=2,
                           host_reorg_slack=0.5)
    fns = (scatter_matmul.deposit_pair, edt_pallas.edt2d,
           gn_batch.solve_window_sq)
    before = [f.launches for f in fns]
    runs = []
    for dev, resident in (("cpu", False), (cuda, False), (cuda, True)):
        pf = PFSlam2D(dataclasses.replace(opts, resident_window=resident),
                      device=dev)
        pf.set_prior(Pose2D(*data.poses_gt[0]))
        flags, poses = [], []
        for k in range(11):
            if pf.update(data.clouds[k], data.odometry[k]) and k:
                flags.append(pf._last_info["resampled"])
                poses.append(pf.pset.pose.cpu().clone())
        runs.append((flags, torch.stack(poses), pf.pset.weight.cpu()))
    (fc, pc, _), (fg, pg, wg), (fr, pr, wr) = runs
    assert fc == fg == fr and len(fc) >= 8 and any(fc)
    assert torch.equal(pg, pr) and torch.equal(wg, wr)
    pc, pg = pc[-1].numpy(), pg[-1].numpy()
    assert np.abs(pc[:, :2] - pg[:, :2]).max() <= 1e-3
    dth = np.angle(np.exp(1j * (np.arctan2(pc[:, 3], pc[:, 2])
                                - np.arctan2(pg[:, 3], pg[:, 2]))))
    assert np.abs(dth).max() <= 1e-3
    assert all(f.launches > b for f, b in zip(fns, before))


SPILL_OPTS = dict(resolution=0.1, patch_size=8, max_range=3.0, l2_max=0.3,
                  trans_thresh=0.15, rot_thresh=0.15, pose_slack=0.5,
                  max_iter=30, capacity=160, use_compression=True)


def _spill_data():
    return simulator.simulate(simulator.SimConfig(
        n_steps=240, seed=4,
        laser=simulator.LaserSpec(n_beams=120, max_range=3.0)))


def test_spill_extract_inject_merge_on_card_equal_cpu(cuda):
    """The spill tier's device half on one state (a CPU spill run's map
    after 120 scans, carried to both devices): extract, inject and
    merged_map on the card equal the CPU's; the blobs are the same bytes."""
    from iris_lama_tpu_torch.sdm import spill
    data = _spill_data()
    slam = Slam2D(Slam2DOptions(**SPILL_OPTS), device="cpu")
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    for k in range(120):
        slam.update(data.clouds[k], data.odometry[k])
    assert slam._spill.spills > 0
    d = state.map_to_numpy(slam.map)
    cfg = slam.cfg
    xy = slam.pose().xy()
    out = {}
    for dev in ("cpu", cuda):
        st = state.map_from_numpy(d, dev)
        store = spill.HostSpillStore(cfg, cfg.geometry)
        store.low = int(st.table.num_patches()) // 2
        active = spill.snapshot_keys(st.table).cpu().numpy()
        victims = store.select_victims(active, xy)
        st, *blocks = spill.extract_patches(st, cfg, victims)
        # half of them back into the pool they left
        st2, drop = spill.inject_patches(st, cfg, victims[::2],
                                         *(b[::2] for b in blocks[:3]))
        # and the store's own spill of the same state, then the merge
        st = store.spill(state.map_from_numpy(d, dev), xy)
        merged, _ = store.merged_map(st)
        out[str(dev)] = (victims, [b.cpu() for b in blocks],
                         state.map_to_numpy(st2), drop.cpu(), dict(
                             store.store), state.map_to_numpy(merged))
    c, g = out["cpu"], out[str(cuda)]
    assert len(c[0]) > 0 and np.array_equal(c[0], g[0])
    for a, b in zip(c[1], g[1]):
        assert torch.equal(a, b)
    for k in c[2]:
        np.testing.assert_array_equal(g[2][k], c[2][k], err_msg=k)
    assert torch.equal(c[3], g[3]) and bool(c[3].all())
    assert c[4] == g[4] and len(c[4]) > 0
    for k in c[5]:
        np.testing.assert_array_equal(g[5][k], c[5][k], err_msg=k)


def test_slam_spill_on_card_matches_cpu(cuda, monkeypatch):
    """Slam2D's spill run (0.1 m, 120 beams, capacity 160) on the card, its
    scan matches replaced by the CPU run's poses: the same spills, refills
    and cache hits, the same stored blobs, the pool bit-equal, and the
    merged map bit-equal to the CPU's."""
    from iris_lama_tpu_torch.match import match_surface_2d
    from iris_lama_tpu_torch.nlls.solver import SolveResult
    data = _spill_data()
    n = 160

    def run(dev):
        slam = Slam2D(Slam2DOptions(**SPILL_OPTS), device=dev)
        slam.set_prior(Pose2D(*data.poses_gt[0]))
        for k in range(n):
            slam.update(data.clouds[k], data.odometry[k])
        return slam

    cpu = run("cpu")
    sp = cpu._spill
    assert sp.spills > 0 and sp.refills > 0
    poses = iter(cpu._traj[1:cpu._n_updates].to(cuda))

    def forced(*args, **kwargs):
        zero = torch.zeros((), device=cuda)
        return SolveResult(next(poses), torch.zeros((), dtype=torch.int32,
                                                    device=cuda),
                           zero, zero, zero)

    monkeypatch.setattr(match_surface_2d, "solve_window", forced)
    gpu = run(cuda)
    gs = gpu._spill
    assert ((gs.spills, gs.refills, gs.cache_hit)
            == (sp.spills, sp.refills, sp.cache_hit))
    assert gs.store == sp.store
    for a, b in ((cpu.map, gpu.map), (cpu.full_map(), gpu.full_map())):
        want, got = state.map_to_numpy(a), state.map_to_numpy(b)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_devprof_reads_the_card(cuda):
    """utils/devprof on a kernel of the port: B2's one launch is one
    activity with device time; ``device_time_ms`` is finite and positive,
    ``device_breakdown`` names the kernel, and ``device_us`` filtered on
    its name holds all of the profile's time."""
    from iris_lama_tpu_torch.utils import devprof
    g = torch.Generator(device=cuda).manual_seed(5)
    grid = torch.randint(0, 101, (488, 488), generator=g, device=cuda,
                         dtype=torch.int8)
    iy, ix = (torch.randint(0, 488, (768,), generator=g, device=cuda,
                            dtype=torch.int32) for _ in range(2))
    select4.select4_sq(grid, iy, ix)          # built and warm
    rows = devprof.cuda_rows(devprof.profile_calls(
        select4.select4_sq, 3, (grid, iy, ix)))
    assert devprof.launch_count(rows) == 3
    total = devprof.device_us(rows)
    assert total > 0 and devprof.device_us(rows, "select4") == total
    ms = devprof.device_time_ms(select4.select4_sq,
                                lambda k: (grid, iy, ix), n=3)
    assert np.isfinite(ms) and 0 < ms < 1.0
    top = devprof.device_breakdown(select4.select4_sq,
                                   lambda k: (grid, iy, ix), n=2)
    assert "select4" in top[0][0] and top[0][1] > 0
