"""Nonlinear least squares: Gauss-Newton / Levenberg-Marquardt IRLS.

reference:
* solver loop — src/nlls/solver.cpp:53-118 (eval -> sqrt-weight rows ->
  strategy step -> tentative update -> revert on invalid);
* GaussNewton — src/nlls/gauss_newton.cpp:53-91 (stop on ||J'r||_inf <
  eps1 or ||h||_inf < eps2, step valid iff chi^2 drops, invalid => stop);
* LevenbergMarquard — src/nlls/levenberg_marquardt.cpp:57-120 (damped
  normal equations, Nielsen mu/nu updates, invalid => larger mu).

One loop: each IRLS step is masked — a step taken after the loop stopped
leaves every carried value unchanged — so the host reads the stop flag
(``utils.trace.host_read``, site ``irls_stop``) only once per
``STOP_CHECK_EVERY`` steps and the loop body has no host read
(a CUDA graph can capture it later). The results equal a plain while loop
(the JAX package's while/scan/unroll modes agree bit for bit). The 3x3
normal equations are explicit float32 sums, never a TF32 product.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..utils.trace import host_read
from .robust import RobustCost, UNIT

# masked IRLS steps per host read of the stop flag
STOP_CHECK_EVERY = 4


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """reference: nlls/solver.h:52-66 Solver::Options."""

    max_iterations: int = 100
    strategy: str = "gn"          # "gn" | "lm"
    robust: RobustCost = UNIT
    eps1: float = 1e-4
    eps2: float = 1e-4
    tau: float = 1e-4             # LM only


class SolveResult(NamedTuple):
    state: torch.Tensor       # final SE(2) state [4]
    iterations: torch.Tensor  # int32 []
    chi2: torch.Tensor        # final weighted chi^2 []
    r: torch.Tensor           # weighted residuals at the final state [B]
    J: torch.Tensor           # weighted Jacobian at the final state [B, 3]


def _weighted(eval_fn, robust: RobustCost, state):
    r, J = eval_fn(state)
    w = torch.sqrt(robust.weight(r))
    return r * w, J * w[:, None]


def _solve3(A, g):
    """Solve A h = -g for 3x3 SPD A via the adjugate (closed form)."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 1], A[1, 2], A[2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    det = a * co00 + b * co01 + c * co02
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    inv_det = torch.where(torch.abs(det) > 1e-30, 1.0 / det,
                          torch.zeros_like(det))
    h0 = -(co00 * g[0] + co01 * g[1] + co02 * g[2]) * inv_det
    h1 = -(co01 * g[0] + co11 * g[1] + co12 * g[2]) * inv_det
    h2 = -(co02 * g[0] + co12 * g[1] + co22 * g[2]) * inv_det
    return torch.stack([h0, h1, h2])


def _normal_equations(r, J):
    """(J'J [3, 3], J'r [3]) as explicit float32 sums over the rows."""
    A = (J[:, :, None] * J[:, None, :]).sum(0)
    g = (J * r[:, None]).sum(0)
    return A, g


def solve(eval_fn: Callable, update_fn: Callable, state0,
          opts: SolverOptions) -> SolveResult:
    """Run the IRLS loop.

    eval_fn: state -> (r [B], J [B, 3]), unweighted residuals/Jacobian.
    update_fn: (state, h [3]) -> state, the manifold update.
    """
    robust = opts.robust
    is_lm = opts.strategy == "lm"
    dev = state0.device
    state = state0
    r, J = _weighted(eval_fn, robust, state0)
    chi2 = torch.sum(r * r)
    mu = torch.tensor(-1.0, device=dev)
    v = torch.tensor(2.0, device=dev)
    stop = torch.tensor(False, device=dev)
    it = torch.tensor(0, dtype=torch.int32, device=dev)
    eye = torch.eye(3, device=dev)
    zero_h = torch.zeros(3, device=dev)

    while True:
        for _ in range(STOP_CHECK_EVERY):
            active = ~stop & (it < opts.max_iterations)
            A, g = _normal_equations(r, J)
            stop_g = torch.amax(torch.abs(g)) < opts.eps1
            if is_lm:
                mu_s = torch.where(mu < 0, opts.tau * torch.amax(A.diagonal()),
                                   mu)
                A = A + mu_s * eye
            else:
                mu_s = mu
            h = torch.where(stop_g, zero_h, _solve3(A, g))
            stop_now = stop_g | (torch.amax(torch.abs(h)) < opts.eps2)

            new_state = update_fn(state, h)
            nr, nJ = _weighted(eval_fn, robust, new_state)
            new_chi2 = torch.sum(nr * nr)
            dF = chi2 - new_chi2
            if is_lm:
                dL = 0.5 * torch.dot(h, mu_s * h - g)
                ok = (dL > 0.0) & (dF > 0.0)
                ratio = torch.where(dL > 0, dF / dL, torch.zeros_like(dF))
                mu_ok = mu_s * torch.clamp(1.0 - (2.0 * ratio - 1.0) ** 3,
                                           min=1.0 / 3.0)
                new_mu = torch.where(ok, mu_ok, mu_s * v)
                new_v = torch.where(ok, torch.full_like(v, 2.0), 2.0 * v)
                stop_after = torch.zeros_like(stop)
            else:
                ok = dF > 0.0
                new_mu, new_v = mu_s, v
                stop_after = ~ok

            take = active & ~stop_now       # the step is taken (solver.cpp:86)
            acc = take & ok                 # ... and accepted
            state = torch.where(acc, new_state, state)
            r = torch.where(acc, nr, r)
            J = torch.where(acc, nJ, J)
            chi2 = torch.where(acc, new_chi2, chi2)
            mu = torch.where(active, torch.where(stop_now, mu_s, new_mu), mu)
            v = torch.where(take, new_v, v)
            stop = torch.where(active, stop_now | stop_after, stop)
            it = it + take.to(torch.int32)
        if not host_read(~stop & (it < opts.max_iterations), "irls_stop"):
            break
    return SolveResult(state=state, iterations=it, chi2=chi2, r=r, J=J)


def covariance(eval_fn, robust: RobustCost, state):
    """Parameter covariance at ``state`` (solver.cpp:122-151)."""
    r, J = eval_fn(state)
    return covariance_from_eval(r, J, robust)


def covariance_from_eval(r, J, robust: RobustCost):
    """Covariance from an unweighted evaluation (solver.cpp:122-151): the
    inverse of J'J when J has full rank (the smallest singular value above
    1e-6 of the largest), else the SVD pseudo-inverse with every singular
    value within 1e-3 of 0 mapped to 3.0 (solver.cpp:143-149).

    ``inv_ex`` does not check for a singular J'J (whose inverse is then
    discarded), so that check costs no host read; ``svd`` on a CUDA tensor
    still waits for the device (cuSOLVER).
    """
    w = torch.sqrt(robust.weight(r))
    J = J * w[:, None]
    A = (J[:, :, None] * J[:, None, :]).sum(0)
    inv, _ = torch.linalg.inv_ex(A)
    _, s, vt = torch.linalg.svd(J, full_matrices=False)
    full_rank = s[-1] > 1e-6 * torch.clamp(s[0], min=1e-30)
    s_inv2 = torch.where(torch.abs(s) > 1e-3, 1.0 / (s * s),
                         torch.full_like(s, 3.0))
    pinv = (vt.T * s_inv2[None, :]) @ vt
    return torch.where(full_rank, inv, pinv)
