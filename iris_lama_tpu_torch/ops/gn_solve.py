"""B4: the whole Gauss-Newton IRLS scan match in one launch.

Each particle solves its scan match against its own squared-distance
window (int8, uint8, int16 or int32, as ``DistanceConfig.sq_dtype``
picks): grids ``[P, H, W]`` with window origins ``[P, 2]`` and start
states ``[P, 4]``, and either one scan per particle (``points_xy [P, B, 2]``,
``mask [P, B]``) or one scan shared by all (``[B, 2]``, ``[B]``). Each
runs the IRLS loop of the reference (solver.cpp:53-118 /
gauss_newton.cpp:53-91): evaluate the ten normal-equation sums
(``match_eval._eval_math`` on B2's corners), stop when ``|g|_inf < eps1``
or ``|h|_inf < eps2`` before a step (not counted as an iteration), else
take the step ``exp(h) * state`` (counted) and keep it iff chi2 drops — an
invalid step reverts and stops. With ``want_lik`` one more evaluation at
the final state with unit weights gives ``sum_d2``, the masked residual
SSE.

The TPU kernel (iris_lama_tpu/ops/gn_solve.py:_kernel) ran one Pallas
program per particle with its window resident in VMEM. On the GPU it is
one CUDA kernel (``csrc/gn_solve.cu``): one thread block per particle that
loops over its own iterations, up to four threads sharing each of the 256
summation lanes of the fixed order (one beam a thread at 768 beams), each
keeping its beams in registers, and every thread running the scalar step
on the broadcast sums; each evaluation is the code it shares with B5
(``csrc/gn_common.cuh``). A window that fits in shared memory beside the
exchange buffer (:func:`staged`: the PF's 432 x 432 at one byte a cell) is
copied there first; a larger one (Loc2D's 576 x 576, or any int16 or int32
window of the PF's) is read from global memory — the variant follows from
the shape and the element size. One instantiation per element type. Scans
of any length: up to ``match_eval.REGISTER_BEAMS`` beams each thread keeps
its beams in registers; beyond that the summing threads read their further
beams from global memory at every evaluation, in the same order.
Loc2D's ``match="solve"`` launches it at P = 1. :func:`solve_window_sq`
launches it for CUDA tensors; :func:`solve_window_sq_plain` is the plain
PyTorch version (a masked loop over all particles, the control flow of the
JAX package's ``match_surface_2d._solve_window_fused``), used for CPU
tensors.

The scalar helpers :func:`_exp_compose` and :func:`_solve3_scalar` work
elementwise on tensors of any (equal) shape, in float32 and in the JAX
package's order of operations; the kernels repeat them statement for
statement.
"""

from __future__ import annotations

import torch

from ..nlls.solver import STOP_CHECK_EVERY
from ..utils.trace import host_read
from ..sdm.geometry import f32
from . import _cuda, match_eval, select4

N_ROWS = 8   # tx ty cos sin chi2 iters sum_d2 pad
# csrc/gn_solve.cu: kDynSmem bytes of dynamic shared memory a block may take
DYN_SMEM = 232_448 - 1_664


def _exp_compose(h0, h1, h2, tx, ty, c, s):
    """state' = exp(h) * state on elementwise tensors (lie.se2_exp +
    se2_compose; the ``|h2| < 1e-4`` Taylor branch of sinc/cosc)."""
    sw, cw = torch.sin(h2), torch.cos(h2)
    small = torch.abs(h2) < f32(1e-4)
    t2 = h2 * h2
    safe = torch.where(small, torch.ones_like(h2), h2)
    sinc = torch.where(small, 1.0 - t2 / 6.0, sw / safe)
    cosc = torch.where(small, h2 / 2.0 - t2 * h2 / 24.0, (1.0 - cw) / safe)
    etx = sinc * h0 - cosc * h1
    ety = cosc * h0 + sinc * h1
    # compose(exp(h), state)
    ntx = etx + cw * tx - sw * ty
    nty = ety + sw * tx + cw * ty
    nc = cw * c - sw * s
    ns = sw * c + cw * s
    return ntx, nty, nc, ns


def _solve3_scalar(a00, a01, a02, a11, a12, a22, g0, g1, g2):
    """h = -A^-1 g for the symmetric 3x3 A, adjugate closed form
    (nlls_solver._solve3); a singular A (|det| <= 1e-30) gives h = 0."""
    co00 = a11 * a22 - a12 * a12
    co01 = a02 * a12 - a01 * a22
    co02 = a01 * a12 - a02 * a11
    det = a00 * co00 + a01 * co01 + a02 * co02
    co11 = a00 * a22 - a02 * a02
    co12 = a01 * a02 - a00 * a12
    co22 = a00 * a11 - a01 * a01
    inv_det = torch.where(torch.abs(det) > f32(1e-30), 1.0 / det,
                          torch.zeros_like(det))
    h0 = -(co00 * g0 + co01 * g1 + co02 * g2) * inv_det
    h1 = -(co01 * g0 + co11 * g1 + co12 * g2) * inv_det
    h2 = -(co02 * g0 + co12 * g1 + co22 * g2) * inv_det
    return h0, h1, h2


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
    steps. The sums are taken in the kernels' order
    (``match_eval._block_sum``), so on the card the two agree bit for
    bit."""
    p, h, w = grid.shape
    fm = mask.to(torch.float32)
    px, py = points_xy[..., 0], points_xy[..., 1]     # [B] or [P, B]
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
        return match_eval._block_sum(torch.stack(terms))    # [10, P]

    st = state0.to(torch.float32)
    sm = sums_at(st, cauchy_c)
    stop = torch.zeros(p, dtype=torch.bool, device=grid.device)
    it = torch.zeros(p, dtype=torch.int32, device=grid.device)
    while host_read((~stop & (it < max_iter)).any(), "irls_stop"):
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

    grid [P, H, W] squared-distance windows (int8, uint8, int16 or
    int32); org_cell int32 [P, 2]
    (window cell (0, 0), [x, y]); state0 f32 [P, 4]; points_xy f32 [P, B, 2]
    and mask bool [P, B] (one scan per particle) or [B, 2] and [B] (one
    scan shared by all). Returns (state f32 [P, 4], iterations int32 [P],
    chi2 f32 [P], sum_d2 f32 [P]; 0 unless ``want_lik``).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous operands of these dtypes and shapes) or raise.
    """
    kw = dict(max_dist=max_dist, res=res, scale=scale,
              cell_offset=cell_offset, cauchy_c=cauchy_c, eps1=eps1,
              eps2=eps2, max_iter=max_iter, want_lik=want_lik)
    if grid.device.type == "cpu":
        return solve_window_sq_plain(grid, org_cell, state0, points_xy, mask,
                                     **kw)
    return _launch(grid, org_cell, state0, points_xy, mask, **kw)


def staged(h: int, w: int, b: int, itemsize: int = 1) -> bool:
    """Whether the kernel copies an ``[h, w]`` window of ``itemsize``-byte
    cells into shared memory for a scan of ``b`` beams (else it reads the
    window from global memory): the window and its 16 bytes of alignment
    slack beside the buffer through which the threads that share a logical
    thread's beams pass their terms (csrc/gn_solve.cu: Shape; beyond
    ``match_eval.REGISTER_BEAMS`` beams that of ``REGISTER_BEAMS``)."""
    pt = max(1, -(-min(b, match_eval.REGISTER_BEAMS) // match_eval.THREADS))
    q = min(pt, 4)
    x_bytes = (pt - -(-pt // q)) * match_eval.N_OUT * match_eval.THREADS * 4
    return x_bytes + h * w * itemsize + 16 <= DYN_SMEM


def _launch(grid, org_cell, state0, points_xy, mask, *, max_dist, res,
            scale, cell_offset, cauchy_c, eps1, eps2, max_iter, want_lik):
    """Check the operands and launch the whole-solve kernel (per-particle
    scans at stride B, a shared scan at stride 0)."""
    dev = grid.device
    per_particle = points_xy.dim() == 3
    _cuda.require(grid, "grid", None, 3, dev)
    code = _cuda.sq_code(grid, "grid")
    _cuda.require(org_cell, "org_cell", torch.int32, 2, dev)
    _cuda.require(state0, "state0", torch.float32, 2, dev)
    _cuda.require(points_xy, "points_xy", torch.float32,
                  3 if per_particle else 2, dev)
    _cuda.require(mask, "mask", torch.bool, 2 if per_particle else 1, dev)
    p, h, w = grid.shape
    b = points_xy.shape[-2]
    scan = (p, b) if per_particle else (b,)
    if (org_cell.shape != (p, 2) or state0.shape != (p, 4)
            or points_xy.shape != (*scan, 2) or mask.shape != scan):
        raise ValueError(
            f"gn_solve: grid {tuple(grid.shape)}, org_cell "
            f"{tuple(org_cell.shape)}, state0 {tuple(state0.shape)}, "
            f"points_xy {tuple(points_xy.shape)}, mask {tuple(mask.shape)}")
    robust = float(cauchy_c) > 0.0
    cinv = f32(1.0 / (cauchy_c * cauchy_c)) if robust else 0.0
    consts = (f32(max_dist), f32(res), f32(scale), cinv, int(robust),
              f32(eps1), f32(eps2), int(cell_offset), int(max_iter),
              int(bool(want_lik)))
    out = torch.empty((N_ROWS, p), dtype=torch.float32, device=dev)
    err = _cuda.library("gn_solve").gn_solve_batched(
        grid.data_ptr(), code, p, h, w, org_cell.data_ptr(),
        state0.data_ptr(), points_xy.data_ptr(), mask.data_ptr(), b,
        b if per_particle else 0, *consts,
        int(staged(h, w, b, grid.element_size())), out.data_ptr(),
        _cuda.stream_handle(dev))
    _cuda.check(err, "gn_solve_batched")
    return _unpack(out)
