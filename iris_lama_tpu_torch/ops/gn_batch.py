"""B6: the batched whole-solve Gauss-Newton IRLS scan match.

One call solves every particle's scan match against its own
squared-distance window (int8, uint8, int16 or int32): grids ``[P, H, W]``
with per-particle window origins ``[P, 2]`` and start states ``[P, 4]``,
one scan ``[B, 2]`` + mask ``[B]`` shared by all. Each particle runs the
IRLS loop of the reference (solver.cpp:53-118 / gauss_newton.cpp:53-91):
evaluate the ten normal-equation sums (``match_eval._eval_math`` on B2's
corners), stop when ``|g|_inf < eps1`` or ``|h|_inf < eps2`` before a step
(not counted as an iteration), else take the step ``exp(h) * state``
(counted) and keep it iff chi2 drops — an invalid step reverts and stops.
With ``want_lik`` one more evaluation at the final state with unit weights
gives ``sum_d2``, the masked residual SSE of the PF likelihood.

The TPU kernel (iris_lama_tpu/ops/gn_batch.py:_kernel) ran all particles
in one Pallas program with every grid VMEM-resident. On the GPU it is B4's
CUDA kernel (``csrc/gn_solve.cu``, ``gn_solve_batched``) with the scan
stride 0: one thread block per particle that loops over its own
iterations. :func:`solve_window_sq` launches it for CUDA tensors;
:func:`solve_window_sq_plain`
is the plain PyTorch version (B4's, a masked loop over all particles),
used for CPU tensors.

The JAX package takes its generic solver for a single particle
(``batch_hint=1``); here B6 serves any P, its results agreeing with the
generic solver within the parity tests' tolerances. Sums are taken in
another order than the generic solver's (and than the JAX kernel's), so
where a stop test lies within an ulp, or the normal matrix is near
singular, a particle can take a different step.
"""

from __future__ import annotations

from . import gn_solve

# The plain version is B4's with the one scan shared by all particles.
solve_window_sq_plain = gn_solve.solve_window_sq_plain


def solve_window_sq(grid, org_cell, state0, points_xy, mask, *,
                    max_dist, res, scale, cell_offset, cauchy_c,
                    eps1, eps2, max_iter, want_lik=False):
    """Whole GN IRLS scan match of every particle, one launch.

    grid [P, H, W] squared-distance windows (int8, uint8, int16 or
    int32); org_cell int32 [P, 2]
    (window cell (0, 0), [x, y]); state0 f32 [P, 4]; points_xy f32 [B, 2]
    and mask bool [B] shared. Returns (state f32 [P, 4], iterations int32
    [P], chi2 f32 [P], sum_d2 f32 [P]; 0 unless ``want_lik``).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous operands of these dtypes and shapes) or raise.
    """
    if points_xy.dim() != 2:
        raise ValueError(f"gn_batch: one shared scan [B, 2] expected, got "
                         f"points_xy {tuple(points_xy.shape)}")
    kw = dict(max_dist=max_dist, res=res, scale=scale,
              cell_offset=cell_offset, cauchy_c=cauchy_c, eps1=eps1,
              eps2=eps2, max_iter=max_iter, want_lik=want_lik)
    if grid.device.type == "cpu":
        return solve_window_sq_plain(grid, org_cell, state0, points_xy, mask,
                                     **kw)
    return gn_solve._launch(grid, org_cell, state0, points_xy, mask, **kw)
