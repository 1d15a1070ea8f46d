"""Point-to-distance-field scan matching (the LaMa core cost).

reference: src/match_surface_2d.cpp:42-122 — residual_i = distance(T *
p_i), Jacobian row [gx, gy, gy*x - gx*y], manifold update
state' = exp(h) * state.
"""

from __future__ import annotations

import torch

from ..core import lie
from ..nlls import solver as nlls_solver
from ..ops import gn_solve, match_eval
from ..sdm import distance as dist_mod
from ..sdm.geometry import MapGeometry
from ..utils.trace import host_read


def make_window_eval(grid, org_cell, geo: MapGeometry, max_dist,
                     points_xy, mask):
    """eval_fn(state) -> (r, J) reading the dense distance window ``grid``.

    points_xy: f32[B, 2] scan points already in the base frame; ``state``
    applies the robot pose on top (match_surface_2d.cpp:49-59).
    """
    fmask = mask.to(torch.float32)

    def eval_fn(state):
        hits = lie.se2_apply(state, points_xy)            # [B, 2]
        d, grad = dist_mod.interp_window(grid, org_cell, geo, hits, max_dist)
        r = d * fmask
        gx, gy = grad[..., 0] * fmask, grad[..., 1] * fmask
        # J = Je * Js with Js = [[1,0,-y],[0,1,x]] (match_surface_2d.cpp:77-88)
        jw = gy * hits[..., 0] - gx * hits[..., 1]
        return r, torch.stack([gx, gy, jw], dim=-1)

    return eval_fn


def update_state(state, h):
    """state' = exp(h) * state (match_surface_2d.cpp:118-122)."""
    return lie.se2_compose(lie.se2_exp(h), state)


def make_pool_eval(table, dist, geo: MapGeometry, max_dist, points_xy, mask):
    """The same cost as :func:`make_window_eval`, reading straight from
    the patch pool (no window)."""
    fmask = mask.to(torch.float32)

    def eval_fn(state):
        hits = lie.se2_apply(state, points_xy)
        d, grad = dist_mod.interp_pool(table, dist, geo, hits, max_dist)
        r = d * fmask
        gx, gy = grad[..., 0] * fmask, grad[..., 1] * fmask
        jw = gy * hits[..., 0] - gx * hits[..., 1]
        return r, torch.stack([gx, gy, jw], dim=-1)

    return eval_fn


def rmse_cells(table, dist, geo: MapGeometry, max_dist, points_xy, mask,
               state):
    """Nearest-cell RMSE (match_surface_2d.cpp:92-116 ``error``), from the
    uninterpolated per-cell distance like the reference."""
    hits = lie.se2_apply(state, points_xy)
    d = dist_mod.cell_distance(table, dist, geo, geo.w2m(hits), max_dist)
    d = d * mask.to(torch.float32)
    n = torch.clamp(mask.sum(), min=1)
    return torch.sqrt(torch.sum(d * d) / n)


ROUTES = ("generic", "solve", "fused")
# the widths of squared-distance windows (DistanceConfig.sq_dtype), each
# with an instantiation of the kernels B2, B4 and B5
SQ_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32)


def solve_window(grid, org_cell, geo, max_dist, points_xy, mask,
                 state0, opts, route: str = "generic"
                 ) -> nlls_solver.SolveResult:
    """Scan-match against a dense window.

    ``route``: ``"generic"`` — the generic IRLS solver over
    :func:`make_window_eval` (any window dtype, GN or LM); ``"solve"`` —
    the whole solve in one launch of kernel B4 (``ops/gn_solve.py``);
    ``"fused"`` — :func:`_solve_window_fused`, one launch of kernel B5 per
    evaluation. The two kernel routes take a squared-distance window of
    any width ``DistanceConfig.sq_dtype`` picks (int8, uint8, int16,
    int32), the GN strategy and a Cauchy or unit robust cost, and raise
    ValueError otherwise (no silent change of solver; :func:`route_serves`
    asks without raising). ``r`` and ``J`` of their result are 0-dim
    zeros.
    """
    if route == "generic":
        eval_fn = make_window_eval(grid, org_cell, geo, max_dist, points_xy,
                                   mask)
        return nlls_solver.solve(eval_fn, update_state, state0, opts)
    check_kernel_route(route, opts, grid.dtype)
    if route == "fused":
        return _solve_window_fused(grid, org_cell, geo, max_dist, points_xy,
                                   mask, state0, opts)
    # B4 takes contiguous operands; a scan's xy columns are a view
    st, it, chi2, _ = gn_solve.solve_window_sq(
        grid[None], org_cell.to(torch.int32).reshape(1, 2),
        state0.reshape(1, 4), points_xy.contiguous(), mask,
        max_dist=max_dist,
        res=geo.resolution, scale=geo.scale, cell_offset=geo.cell_offset,
        cauchy_c=_cauchy_c(opts), eps1=opts.eps1, eps2=opts.eps2,
        max_iter=opts.max_iterations)
    zero = torch.zeros((), device=grid.device)
    return nlls_solver.SolveResult(state=st[0], iterations=it[0],
                                   chi2=chi2[0], r=zero, J=zero)


def _refusal(route: str, opts, dtype):
    """Why ``route`` cannot serve ``opts`` on a window of ``dtype``, or
    None when it can."""
    if route not in ROUTES:
        return f"route {route!r}: expected one of {ROUTES}"
    if route == "generic":
        return None
    if opts.strategy != "gn":
        return (f"route {route!r} runs Gauss-Newton; strategy "
                f"{opts.strategy!r} needs route 'generic'")
    if opts.robust.kind not in ("cauchy", "unit"):
        return (f"route {route!r} weighs by Cauchy or unit; robust cost "
                f"{opts.robust.kind!r} needs route 'generic'")
    if dtype not in SQ_DTYPES:
        return (f"route {route!r} reads an integer squared-distance window "
                f"(int8, uint8, int16, int32), got {dtype}")
    return None


def route_serves(route: str, opts, dtype=torch.int8) -> bool:
    """Whether ``route`` (one of :data:`ROUTES`) can serve the solver
    options ``opts`` on a window of ``dtype``: ``"generic"`` always; the
    kernel routes GN with a Cauchy or unit cost on an integer
    squared-distance window."""
    return _refusal(route, opts, dtype) is None


def check_kernel_route(route: str, opts, dtype=torch.int8) -> None:
    """Raise ValueError, saying why, unless :func:`route_serves` holds
    (both read :func:`_refusal`)."""
    why = _refusal(route, opts, dtype)
    if why is not None:
        raise ValueError(why)


def _cauchy_c(opts) -> float:
    return opts.robust.param if opts.robust.kind == "cauchy" else 0.0


def _solve_window_fused(grid, org_cell, geo, max_dist, points_xy, mask,
                        state0, opts) -> nlls_solver.SolveResult:
    """GN IRLS consuming the fused normal-equation sums of kernel B5.

    The control flow of the JAX package's ``_solve_window_fused``
    (solver.cpp:53-118 / gauss_newton.cpp:53-91) statement for statement:
    eval + weight, eps1/eps2 stops with the converged-before-step
    shortcut, chi2-decrease validity, invalid => stop without applying.
    As in :func:`nlls_solver.solve`, it is one masked loop with a host read
    of the stop flag every ``STOP_CHECK_EVERY`` steps; ``iterations`` and
    ``chi2`` carry the values of a plain while loop. r/J are not
    materialised.
    """
    cauchy_c = _cauchy_c(opts)
    fm = mask.to(torch.float32)
    org = org_cell.to(torch.int32)
    dev = state0.device

    def sums_at(state):
        hits = lie.se2_apply(state, points_xy)
        mi, mu = geo.w2m_frac(hits)
        loc = mi - org
        # the columns pass as views: B5 reads each through its strides
        return match_eval.gn_eval_sq(
            grid, loc[..., 1], loc[..., 0], mu[..., 0], mu[..., 1],
            hits[..., 0], hits[..., 1], fm, max_dist=max_dist,
            res=geo.resolution, scale=geo.scale, cauchy_c=cauchy_c)

    # the carry holds the evaluation (the 10 sums) at the current state, so
    # each step runs exactly one fused evaluation — the candidate's
    state = state0
    s = sums_at(state0)
    stop = torch.tensor(False, device=dev)
    it = torch.tensor(0, dtype=torch.int32, device=dev)
    while True:
        for _ in range(nlls_solver.STOP_CHECK_EVERY):
            active = ~stop & (it < opts.max_iterations)
            A = torch.stack([torch.stack([s[0], s[1], s[2]]),
                             torch.stack([s[1], s[3], s[4]]),
                             torch.stack([s[2], s[4], s[5]])])
            g = s[6:9]
            stop_g = torch.amax(torch.abs(g)) < opts.eps1
            h = torch.where(stop_g, torch.zeros_like(g),
                            nlls_solver._solve3(A, g))
            stop_now = stop_g | (torch.amax(torch.abs(h)) < opts.eps2)
            new_state = update_state(state, h)
            ns = sums_at(new_state)
            ok = (s[9] - ns[9]) > 0.0
            take = active & ~stop_now
            acc = take & ok
            state = torch.where(acc, new_state, state)
            s = torch.where(acc, ns, s)
            stop = torch.where(active, stop_now | ~ok, stop)
            it = it + take.to(torch.int32)
        if not host_read(~stop & (it < opts.max_iterations), "irls_stop"):
            break
    zero = torch.zeros((), device=dev)
    return nlls_solver.SolveResult(state=state, iterations=it, chi2=s[9],
                                   r=zero, J=zero)


def solve_pool(table, dist, geo, max_dist, points_xy, mask,
               state0, opts) -> nlls_solver.SolveResult:
    """Scan-match straight against the pool (Loc2D with loaded maps)."""
    eval_fn = make_pool_eval(table, dist, geo, max_dist, points_xy, mask)
    return nlls_solver.solve(eval_fn, update_state, state0, opts)
