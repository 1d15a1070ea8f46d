"""B6: the batched whole-solve Gauss-Newton IRLS scan match.

One call solves every particle's scan match against its own s8
squared-distance window: grids ``[P, H, W]`` with per-particle window
origins ``[P, 2]`` and start states ``[P, 4]``, one scan ``[B, 2]`` + mask
``[B]`` shared by all. Each particle runs the IRLS loop of the reference
(solver.cpp:53-118 / gauss_newton.cpp:53-91): evaluate the ten normal-
equation sums (``match_eval._eval_math`` on B2's corners), stop when
``|g|_inf < eps1`` or ``|h|_inf < eps2`` before a step (not counted as an
iteration), else take the step ``exp(h) * state`` (counted) and keep it
iff chi2 drops — an invalid step reverts and stops. With ``want_lik`` one
more evaluation at the final state with unit weights gives ``sum_d2``, the
masked residual SSE of the PF likelihood.

The TPU kernel (iris_lama_tpu/ops/gn_batch.py:_kernel) ran all particles
in one Pallas program with every grid VMEM-resident. On the GPU it is one
CUDA kernel (``csrc/gn_batch.cu``): one thread block per particle that
loops over its own iterations. :func:`solve_window_sq` launches it for
CUDA tensors; :func:`solve_window_sq_plain` is the plain PyTorch version
(a masked loop over all particles, the control flow of the JAX package's
``match_surface_2d._solve_window_fused``), used for CPU tensors.

The JAX package takes its generic solver for a single particle
(``batch_hint=1``); here B6 serves any P, its results agreeing with the
generic solver within the parity tests' tolerances. Sums are taken in
another order than the generic solver's (and than the JAX kernel's), so
where a stop test lies within an ulp, or the normal matrix is near
singular, a particle can take a different step.
"""

from __future__ import annotations

import torch

from ..nlls.solver import STOP_CHECK_EVERY
from ..sdm.geometry import f32
from . import _cuda, match_eval, select4
from .gn_solve import _exp_compose, _solve3_scalar

N_ROWS = 8   # tx ty cos sin chi2 iters sum_d2 pad
THREADS, LANES = 256, 32   # csrc/gn_batch.cu: threads per block, warp


def _block_sum(x):
    """Sum over the last (beam) axis in the order of the kernel's block
    reduction, so that the plain version and the kernel add the same
    float32 values in the same order: thread ``t`` adds beams ``t``,
    ``t + 256``, ... in turn; each warp of 32 threads halves by shuffle-down
    (lane ``i`` adds lane ``i + 16``, then ``i + 8``, ... ``i + 1``); thread
    0 adds the eight warp totals in turn."""
    b = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (-b) % THREADS))
    x = x.reshape(*x.shape[:-1], -1, THREADS)
    acc = x[..., 0, :]
    for j in range(1, x.shape[-2]):
        acc = acc + x[..., j, :]
    v = acc.reshape(*acc.shape[:-1], THREADS // LANES, LANES)
    off = LANES // 2
    while off:
        v = v[..., :off] + v[..., off:2 * off]
        off //= 2
    t = v[..., 0, 0]
    for j in range(1, THREADS // LANES):
        t = t + v[..., j, 0]
    return t


def _unpack(rows):
    """[N_ROWS, P] rows -> (state [P, 4], iterations int32 [P], chi2 [P],
    sum_d2 [P])."""
    return (rows[0:4].t().contiguous(), rows[5].to(torch.int32), rows[4],
            rows[6])


def solve_window_sq_plain(grid, org_cell, state0, points_xy, mask, *,
                          max_dist, res, scale, cell_offset, cauchy_c,
                          eps1, eps2, max_iter, want_lik=False):
    """Plain PyTorch version of :func:`solve_window_sq`: every particle
    steps in one masked loop (a stopped particle's values stay as they
    are), with a host read of the stop flags every ``STOP_CHECK_EVERY``
    steps. The sums are taken in the kernel's order (:func:`_block_sum`),
    so on the card the two agree bit for bit."""
    p, h, w = grid.shape
    fm = mask.to(torch.float32)
    px, py = points_xy[:, 0], points_xy[:, 1]
    org = org_cell.to(torch.int32)
    scl = f32(scale)

    def sums_at(st, cc):
        tx, ty, c, s = (st[:, k:k + 1] for k in range(4))
        # lie.se2_apply + geometry.w2m_frac (floor + integer offset)
        hx = tx + c * px - s * py
        hy = ty + s * px + c * py
        mfx, mfy = hx * scl, hy * scl
        flx, fly = torch.floor(mfx), torch.floor(mfy)
        lx = flx.to(torch.int32) + cell_offset - org[:, 0:1]
        ly = fly.to(torch.int32) + cell_offset - org[:, 1:2]
        v = select4.select4_sq_plain(grid, ly, lx)
        terms = match_eval._eval_math(
            ly, lx, v[0], v[1], v[2], v[3], mfx - flx, mfy - fly, hx, hy,
            fm, h, w, max_dist, res, scale, cc, total=lambda x: x)
        return _block_sum(torch.stack(terms))             # [10, P]

    st = state0.to(torch.float32)
    sm = sums_at(st, cauchy_c)
    stop = torch.zeros(p, dtype=torch.bool, device=grid.device)
    it = torch.zeros(p, dtype=torch.int32, device=grid.device)
    while bool((~stop & (it < max_iter)).any()):
        for _ in range(STOP_CHECK_EVERY):
            active = ~stop & (it < max_iter)
            g_max = torch.maximum(torch.maximum(sm[6].abs(), sm[7].abs()),
                                  sm[8].abs())
            stop_g = g_max < f32(eps1)
            hs = _solve3_scalar(*sm[:9])
            hs = [torch.where(stop_g, torch.zeros_like(v), v) for v in hs]
            h_max = torch.maximum(torch.maximum(hs[0].abs(), hs[1].abs()),
                                  hs[2].abs())
            stop_now = stop_g | (h_max < f32(eps2))
            cand = torch.stack(_exp_compose(*hs, *st.unbind(-1)), dim=-1)
            nsm = sums_at(cand, cauchy_c)
            ok = (sm[9] - nsm[9]) > 0.0
            take = active & ~stop_now        # the step is taken: it += 1
            acc = take & ok                  # ... and kept
            st = torch.where(acc[:, None], cand, st)
            sm = torch.where(acc[None, :], nsm, sm)
            stop = stop | (active & (stop_now | ~ok))
            it = it + take.to(torch.int32)
    if want_lik:
        sum_d2 = sums_at(st, 0.0)[9]
    else:
        sum_d2 = torch.zeros_like(sm[9])
    return st, it, sm[9], sum_d2


def solve_window_sq(grid, org_cell, state0, points_xy, mask, *,
                    max_dist, res, scale, cell_offset, cauchy_c,
                    eps1, eps2, max_iter, want_lik=False):
    """Whole GN IRLS scan match of every particle, one launch.

    grid int8 [P, H, W] squared-distance windows; org_cell int32 [P, 2]
    (window cell (0, 0), [x, y]); state0 f32 [P, 4]; points_xy f32 [B, 2]
    and mask bool [B] shared. Returns (state f32 [P, 4], iterations int32
    [P], chi2 f32 [P], sum_d2 f32 [P]; 0 unless ``want_lik``).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous operands of these dtypes and shapes) or raise.
    """
    kw = dict(max_dist=max_dist, res=res, scale=scale,
              cell_offset=cell_offset, cauchy_c=cauchy_c, eps1=eps1,
              eps2=eps2, max_iter=max_iter, want_lik=want_lik)
    if grid.device.type == "cpu":
        return solve_window_sq_plain(grid, org_cell, state0, points_xy, mask,
                                     **kw)
    dev = grid.device
    _cuda.require(grid, "grid", torch.int8, 3, dev)
    _cuda.require(org_cell, "org_cell", torch.int32, 2, dev)
    _cuda.require(state0, "state0", torch.float32, 2, dev)
    _cuda.require(points_xy, "points_xy", torch.float32, 2, dev)
    _cuda.require(mask, "mask", torch.bool, 1, dev)
    p, h, w = grid.shape
    b = points_xy.shape[0]
    if (org_cell.shape != (p, 2) or state0.shape != (p, 4)
            or points_xy.shape != (b, 2) or mask.shape != (b,)):
        raise ValueError(
            f"gn_batch: grid {tuple(grid.shape)}, org_cell "
            f"{tuple(org_cell.shape)}, state0 {tuple(state0.shape)}, "
            f"points_xy {tuple(points_xy.shape)}, mask {tuple(mask.shape)}")
    px = points_xy[:, 0].contiguous()
    py = points_xy[:, 1].contiguous()
    fm = mask.to(torch.float32)
    robust = float(cauchy_c) > 0.0
    cinv = f32(1.0 / (cauchy_c * cauchy_c)) if robust else 0.0
    out = torch.empty((N_ROWS, p), dtype=torch.float32, device=dev)
    lib = _cuda.library("gn_batch")
    _cuda.check(lib.gn_batch_solve(
        grid.data_ptr(), p, h, w, org_cell.data_ptr(), state0.data_ptr(),
        px.data_ptr(), py.data_ptr(), fm.data_ptr(), b, f32(max_dist),
        f32(res), f32(scale), cinv, int(robust), f32(eps1), f32(eps2),
        int(cell_offset), int(max_iter), int(bool(want_lik)), out.data_ptr(),
        _cuda.stream_handle(dev)), "gn_batch_solve")
    solve_window_sq.launches += 1
    return _unpack(out)


solve_window_sq.launches = 0
