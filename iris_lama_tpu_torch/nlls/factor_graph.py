"""Batched SE(2) factor-graph optimization (the vendored-minisam replacement).

reference: vendor/minisam — FactorGraph + PriorFactor/BetweenFactor over
Sophus SE2 (minisam/slam/BetweenFactor.h:50-59), and the Levenberg-
Marquardt, Gauss-Newton and dogleg optimizers over a Cholesky solve.
Used by SimplePGO (src/simple_pgo.cpp:48-105) and GraphSlam2D
(src/graph_slam2d.cpp:394-430).

Factors are padded, masked tensors. Residuals and their tangent Jacobians
come from forward-mode differentiation of the residual over all factors at
once: each value carries its tangents along the residual's operations
(the JAX package's ``vmap`` + ``jacfwd``; no hand-derived Jacobian). The Gauss-Newton Hessian is assembled by scatter-adding 3x3
blocks into a dense ``[3N, 3N]`` float32 matrix and solved with a dense
Cholesky factor (``torch.linalg.cholesky_ex``, which neither raises nor
waits for the device on a matrix that is not positive definite: such a
factor is set to NaN, so the step is refused as a failed factorization is
in the JAX package). Retraction is x <- x * exp(delta).

The optimizer loop masks each step once the loop is done, and the host
reads the stop flag once per ``STOP_CHECK_EVERY`` steps (as
``nlls/solver.py`` does; read site ``pgo_stop``); nodes, damping, chi2 and
the iteration count come out as a plain while loop gives them.

Losses: diagonal sigmas scale residual rows (DiagonalLoss::Sigmas); Huber
on the residual norm for loop-closure factors (sam::HuberLoss::Huber(0.1),
graph_slam2d.cpp:266).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..utils.trace import host_read
from .solver import STOP_CHECK_EVERY


class SE2Graph(NamedTuple):
    """Padded factor tensors. All "idx" entries of padding rows are 0 with
    mask False."""

    # prior factors: r = w * log(meas^-1 * x_i)
    prior_idx: torch.Tensor     # int64 [Np]
    prior_meas: torch.Tensor    # f32 [Np, 4] SE(2)
    prior_w: torch.Tensor       # f32 [Np, 3] (1/sigma per dim)
    prior_mask: torch.Tensor    # bool [Np]
    # between factors: r = w * log(meas^-1 * (x_i^-1 * x_j))
    bet_i: torch.Tensor         # int64 [Nb]
    bet_j: torch.Tensor         # int64 [Nb]
    bet_meas: torch.Tensor      # f32 [Nb, 4]
    bet_w: torch.Tensor         # f32 [Nb, 3]
    bet_huber: torch.Tensor     # f32 [Nb] — Huber k on ||r||; 0 = none
    bet_mask: torch.Tensor      # bool [Nb]


@dataclasses.dataclass(frozen=True)
class PGOOptions:
    """Optimizer knobs (minisam *OptimizerParams defaults).

    strategy: "lm" (LevenbergMarquardtOptimizer), "gn"
    (GaussNewtonOptimizer — undamped steps, stop on non-improvement) or
    "dogleg" (DoglegOptimizer — Powell's dogleg on a trust region whose
    radius the gain ratio adapts).
    """

    max_iterations: int = 50
    strategy: str = "lm"
    lambda_init: float = 1e-5
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    rtol: float = 1e-6
    radius_init: float = 1.0      # dogleg trust-region radius (minisam)


def _prior_residual(x, meas, w):
    return w * lie.se2_log(lie.se2_compose(lie.se2_inverse(meas), x))


def _between_residual(xi, xj, meas, w):
    rel = lie.se2_compose(lie.se2_inverse(xi), xj)
    return w * lie.se2_log(lie.se2_compose(lie.se2_inverse(meas), rel))


def _huber_scale(r, k):
    """sqrt of the Huber weight on the residual norm (minisam HuberLoss);
    ``r`` [..., 3], ``k`` [...]."""
    n = torch.sqrt(torch.sum(r * r, dim=-1))
    w = torch.where((k > 0) & (n > k), k / torch.clamp(n, min=1e-12),
                    torch.ones_like(n))
    return torch.sqrt(w)


class _Dual(NamedTuple):
    """A float32 value [F] and its tangents [F, D] (forward mode)."""

    v: torch.Tensor
    t: torch.Tensor

    def __add__(self, o):
        return _Dual(self.v + o.v, self.t + o.t)

    def __sub__(self, o):
        return _Dual(self.v - o.v, self.t - o.t)

    def __neg__(self):
        return _Dual(-self.v, -self.t)

    def __mul__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v * o.v,
                         self.t * o.v[:, None] + self.v[:, None] * o.t)
        return _Dual(self.v * o, self.t * o)

    def __truediv__(self, o):
        if isinstance(o, _Dual):
            q = self.v / o.v
            return _Dual(q, self.t / o.v[:, None]
                         - (self.v / (o.v * o.v))[:, None] * o.t)
        return _Dual(self.v / o, self.t / o)

    def where(self, cond, o):
        return _Dual(torch.where(cond, self.v, o.v),
                     torch.where(cond[:, None], self.t, o.t))


def _const(v, d: int):
    return _Dual(v, torch.zeros((v.shape[0], d), dtype=v.dtype,
                                device=v.device))


def _perturbed(x, d: int, k: int):
    """x * exp(delta) at delta = 0, delta in tangent columns k..k+2 of d:
    the value is x and the tangents are exact (exp's Jacobian at 0 is the
    identity)."""
    c, s = x[:, 2], x[:, 3]
    t = torch.zeros((4, x.shape[0], d), dtype=x.dtype, device=x.device)
    t[0, :, k], t[0, :, k + 1] = c, -s
    t[1, :, k], t[1, :, k + 1] = s, c
    t[2, :, k + 2] = -s
    t[3, :, k + 2] = c
    return tuple(_Dual(x[:, i], t[i]) for i in range(4))


def _d_compose(a, b):
    """lie.se2_compose on duals (tx, ty, c, s)."""
    ax, ay, ca, sa = a
    bx, by, cb, sb = b
    return (ax + ca * bx - sa * by, ay + sa * bx + ca * by,
            ca * cb - sa * sb, sa * cb + ca * sb)


def _d_inverse(g):
    """lie.se2_inverse on duals."""
    tx, ty, c, s = g
    return (-(c * tx + s * ty), -(-s * tx + c * ty), c, -s)


def _d_log(g):
    """lie.se2_log on duals: [F, 3] values and [F, 3, D] tangents."""
    tx, ty, c, s = g
    den = s.v * s.v + c.v * c.v
    theta = _Dual(torch.atan2(s.v, c.v), s.t * (c.v / den)[:, None]
                  - c.t * (s.v / den)[:, None])
    small = torch.abs(theta.v) < 1e-4
    t2 = theta * theta
    one = torch.ones_like(theta.v)
    safe = _const(one, theta.t.shape[1]).where(small, theta)
    sin = _Dual(torch.sin(safe.v), torch.cos(safe.v)[:, None] * safe.t)
    cos = _Dual(torch.cos(safe.v), -torch.sin(safe.v)[:, None] * safe.t)
    one_d = _const(one, theta.t.shape[1])
    sinc = (one_d - t2 / 6.0).where(small, sin / safe)
    cosc = (theta / 2.0 - t2 * theta / 24.0).where(small,
                                                   (one_d - cos) / safe)
    det = sinc * sinc + cosc * cosc
    v1 = (sinc * tx + cosc * ty) / det
    v2 = (-cosc * tx + sinc * ty) / det
    return (torch.stack([v1.v, v2.v, theta.v], dim=-1),
            torch.stack([v1.t, v2.t, theta.t], dim=-2))


def _se2_const(g, d: int):
    return tuple(_const(g[:, k], d) for k in range(4))


def _linearize(nodes, graph: SE2Graph):
    """Residuals and tangent Jacobian blocks of every factor.

    Perturbation convention: x -> x * exp(d) (right/local, minisam's Sophus
    traits), so the solved delta retracts the same way. Forward mode: each
    value carries its tangents along the residual's operations (the
    JAX package's ``jacfwd``). Returns (pr [Np, 3], pJ [Np, 3, 3], br [Nb,
    3], bJi, bJj [Nb, 3, 3]), each masked and the betweens Huber-scaled.
    """
    x = _perturbed(nodes[graph.prior_idx], 3, 0)
    e = _d_compose(_d_inverse(_se2_const(graph.prior_meas, 3)), x)
    pr, pJ = _d_log(e)
    w = graph.prior_w
    m = graph.prior_mask.to(torch.float32)
    pr = w * pr * m[:, None]
    pJ = w[:, :, None] * pJ * m[:, None, None]

    xi = _perturbed(nodes[graph.bet_i], 6, 0)
    xj = _perturbed(nodes[graph.bet_j], 6, 3)
    rel = _d_compose(_d_inverse(xi), xj)
    e = _d_compose(_d_inverse(_se2_const(graph.bet_meas, 6)), rel)
    br, bJ = _d_log(e)
    w = graph.bet_w
    br = w * br
    bJ = w[:, :, None] * bJ
    s = _huber_scale(br, graph.bet_huber) * graph.bet_mask.to(torch.float32)
    return (pr, pJ, br * s[:, None], bJ[:, :, :3] * s[:, None, None],
            bJ[:, :, 3:] * s[:, None, None])


def _residuals(nodes, graph: SE2Graph):
    """(pr, br): the residuals of :func:`_linearize` without Jacobians."""
    pr = _prior_residual(nodes[graph.prior_idx], graph.prior_meas,
                         graph.prior_w)
    pr = pr * graph.prior_mask.to(torch.float32)[:, None]
    br = _between_residual(nodes[graph.bet_i], nodes[graph.bet_j],
                           graph.bet_meas, graph.bet_w)
    s = _huber_scale(br, graph.bet_huber) * graph.bet_mask.to(torch.float32)
    return pr, br * s[:, None]


def _jtj(a, b):
    return torch.einsum("fab,fac->fbc", a, b)


def _normal_equations(nodes, graph: SE2Graph, active_mask):
    """Assemble H [3N, 3N], g [3N] and chi2 by block scatter-add (priors,
    then the between blocks ii, jj, ij, ji, then the identity on inactive
    padding nodes, which keeps H nonsingular)."""
    n = nodes.shape[0]
    dev = nodes.device
    pr, pJ, br, bJi, bJj = _linearize(nodes, graph)
    pi, bi, bj = graph.prior_idx, graph.bet_i, graph.bet_j

    H = torch.zeros((n * n, 3, 3), dtype=torch.float32, device=dev)
    H.index_add_(0, pi * (n + 1), _jtj(pJ, pJ))
    H.index_add_(0, bi * (n + 1), _jtj(bJi, bJi))
    H.index_add_(0, bj * (n + 1), _jtj(bJj, bJj))
    H.index_add_(0, bi * n + bj, _jtj(bJi, bJj))
    H.index_add_(0, bj * n + bi, _jtj(bJj, bJi))
    pad = (~active_mask).to(torch.float32)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    H.index_add_(0, torch.arange(n, device=dev) * (n + 1),
                 pad[:, None, None] * eye)

    g = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    g.index_add_(0, pi, torch.einsum("fab,fa->fb", pJ, pr))
    g.index_add_(0, bi, torch.einsum("fab,fa->fb", bJi, br))
    g.index_add_(0, bj, torch.einsum("fab,fa->fb", bJj, br))

    chi2 = torch.sum(pr * pr) + torch.sum(br * br)
    H = H.reshape(n, n, 3, 3).permute(0, 2, 1, 3).reshape(3 * n, 3 * n)
    return H, g.reshape(3 * n), chi2


def _chi2_only(nodes, graph: SE2Graph):
    pr, br = _residuals(nodes, graph)
    return torch.sum(pr * pr) + torch.sum(br * br)


def _cho_solve(A, b):
    """Solve A x = b through a Cholesky factor of A; NaN where A is not
    positive definite (no host read)."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    L = torch.where(info > 0, torch.full_like(L, float("nan")), L)
    return torch.cholesky_solve(b[:, None], L)[:, 0]


def _dogleg(delta, g, H, radius):
    """Powell's dogleg (minisam/nonlinear/DoglegOptimizer.cpp): the GN step
    inside the radius, the clipped steepest-descent step if even it leaves
    it, else the blend on the segment between them that meets the radius."""
    gg = torch.dot(g, g)
    gHg = torch.dot(g, H @ g)
    alpha = gg / torch.clamp(gHg, min=1e-30)
    h_sd = -alpha * g
    n_gn = torch.sqrt(torch.dot(delta, delta))
    n_sd = torch.sqrt(torch.dot(h_sd, h_sd))
    v = delta - h_sd
    a = torch.dot(v, v)
    b = 2.0 * torch.dot(h_sd, v)
    cc = torch.dot(h_sd, h_sd) - radius * radius
    disc = torch.clamp(b * b - 4 * a * cc, min=0.0)
    beta = (-b + torch.sqrt(disc)) / torch.clamp(2 * a, min=1e-30)
    h_blend = h_sd + beta * v
    return torch.where(
        n_gn <= radius, delta,
        torch.where(n_sd >= radius,
                    h_sd * (radius / torch.clamp(n_sd, min=1e-30)), h_blend))


def optimize(nodes, graph: SE2Graph, active_mask,
             opts: PGOOptions = PGOOptions()):
    """Optimize the pose graph. nodes f32 [N, 4] SE(2); active_mask bool [N].

    Returns (nodes, info) with ``info["chi2"]`` and ``info["iterations"]``
    (device tensors). The strategy is ``opts.strategy``; ``lam`` doubles as
    the dogleg's trust radius.
    """
    n = nodes.shape[0]
    dev = nodes.device
    is_lm = opts.strategy == "lm"
    is_dl = opts.strategy == "dogleg"
    if opts.strategy not in ("lm", "gn", "dogleg"):
        raise ValueError(f"strategy {opts.strategy!r}: expected 'lm', 'gn' "
                         "or 'dogleg'")
    lam = torch.tensor(opts.radius_init if is_dl else opts.lambda_init,
                       dtype=torch.float32, device=dev)
    chi2 = _chi2_only(nodes, graph)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    act = active_mask.to(torch.float32)[:, None]

    while True:
        for _ in range(STOP_CHECK_EVERY):
            active = ~done & (it < opts.max_iterations)
            H, g, chi2_now = _normal_equations(nodes, graph, active_mask)
            Hd = H + torch.diag(lam * torch.diagonal(H)) if is_lm else H
            delta = _cho_solve(Hd, -g)
            if is_dl:
                delta = _dogleg(delta, g, H, lam)
            delta = delta.reshape(n, 3) * act
            new_nodes = lie.se2_compose(nodes, lie.se2_exp(delta))
            new_chi2 = _chi2_only(new_nodes, graph)
            improved = new_chi2 < chi2_now
            new_lam = lam
            if is_lm:
                new_lam = torch.clamp(
                    torch.where(improved, lam * opts.lambda_down,
                                lam * opts.lambda_up), 1e-9, 1e6)
            elif is_dl:
                df = delta.reshape(-1)
                pred = -(torch.dot(g, df) + 0.5 * torch.dot(df, H @ df))
                rho = (chi2_now - new_chi2) / torch.clamp(pred, min=1e-30)
                grown = torch.maximum(lam, 3.0 * torch.sqrt(torch.dot(df, df)))
                new_lam = torch.clamp(
                    torch.where(rho > 0.75, grown,
                                torch.where(rho < 0.25, lam * 0.5, lam)),
                    1e-6, 1e6)
            rel = (torch.abs(chi2_now - new_chi2)
                   / torch.clamp(chi2_now, min=1e-12))
            new_done = (improved & (rel < opts.rtol)) | (
                torch.amax(torch.abs(delta)) < 1e-8)
            if not is_lm and not is_dl:
                # GN: a non-improving undamped step means we are done
                new_done = new_done | ~improved
            nodes = torch.where(active & improved, new_nodes, nodes)
            lam = torch.where(active, new_lam, lam)
            chi2 = torch.where(active, torch.where(improved, new_chi2,
                                                   chi2_now), chi2)
            it = it + active.to(torch.int32)
            done = torch.where(active, new_done, done)
        if not host_read(~done & (it < opts.max_iterations), "pgo_stop"):
            break
    return nodes, {"chi2": chi2, "iterations": it}


def marginal_covariance(nodes, graph: SE2Graph, active_mask, idx: int):
    """3x3 marginal covariance block of node ``idx`` at the solution: the
    (idx, idx) block of the inverse Gauss-Newton Hessian (minisam's
    MarginalCovariance). The block's start is clamped into the matrix, as
    ``lax.dynamic_slice`` clamps it."""
    H, _, _ = _normal_equations(nodes, graph, active_mask)
    Hinv, _ = torch.linalg.inv_ex(H)
    k = min(max(3 * int(idx), 0), H.shape[0] - 3)
    return Hinv[k:k + 3, k:k + 3]


# ---------------------------------------------------------------------------
# Host-side graph builder (padded)
# ---------------------------------------------------------------------------

class GraphBuilder:
    """Accumulates factors on the host; ``finalize`` pads them to buckets of
    64 rows (few distinct shapes as a graph grows)."""

    def __init__(self):
        self.priors = []      # (idx, se2_meas[4], sigmas[3])
        self.betweens = []    # (i, j, se2_meas[4], sigmas[3], huber_k)

    def add_prior(self, idx, meas_se2, sigmas):
        self.priors.append((idx, np.asarray(meas_se2, np.float32),
                            np.asarray(sigmas, np.float32)))

    def add_between(self, i, j, meas_se2, sigmas, huber_k=0.0):
        self.betweens.append((i, j, np.asarray(meas_se2, np.float32),
                              np.asarray(sigmas, np.float32), huber_k))

    @staticmethod
    def _bucket(k, q=64):
        return max(q, ((k + q - 1) // q) * q)

    def finalize(self, device=None) -> SE2Graph:
        np_ = self._bucket(max(len(self.priors), 1))
        nb = self._bucket(max(len(self.betweens), 1))
        ident = np.array([0, 0, 1, 0], np.float32)

        p_idx = np.zeros(np_, np.int64)
        p_meas = np.tile(ident, (np_, 1))
        p_w = np.zeros((np_, 3), np.float32)
        p_mask = np.zeros(np_, bool)
        for k, (i, m, s) in enumerate(self.priors):
            p_idx[k], p_meas[k], p_w[k], p_mask[k] = i, m, 1.0 / s, True

        b_i = np.zeros(nb, np.int64)
        b_j = np.zeros(nb, np.int64)
        b_meas = np.tile(ident, (nb, 1))
        b_w = np.zeros((nb, 3), np.float32)
        b_k = np.zeros(nb, np.float32)
        b_mask = np.zeros(nb, bool)
        for k, (i, j, m, s, hk) in enumerate(self.betweens):
            b_i[k], b_j[k], b_meas[k] = i, j, m
            b_w[k], b_k[k], b_mask[k] = 1.0 / s, hk, True

        return SE2Graph(*(torch.as_tensor(a, device=device) for a in (
            p_idx, p_meas, p_w, p_mask, b_i, b_j, b_meas, b_w, b_k, b_mask)))
