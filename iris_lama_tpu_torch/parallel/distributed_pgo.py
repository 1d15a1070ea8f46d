"""Distributed pose-graph Gauss-Newton: matrix-free GN-CG over a process
group.

The JAX package's design (``iris_lama_tpu/parallel/distributed_pgo.py``),
with explicit collectives in place of GSPMD's:

* the factors (priors and betweens) are split over the ranks
  (:func:`shard_graph`); each rank linearises its own factors with the
  forward-mode Jacobian blocks of ``nlls/factor_graph._linearize`` (the
  JAX package takes ``jvp``/``vjp`` through the residual; both freeze the
  Huber scale at the linearisation point) with no communication;
* the gradient g = J^T r, every Hessian-vector product H v = J^T (J v),
  the per-node 3x3 blocks of the block-Jacobi preconditioner and both chi2
  sums are sums over factors: a step's chi2, g and blocks go in one sum
  all-reduce, each H v and the new chi2 in one each. The Hessian is
  never formed, so a graph whose dense [3N, 3N] Hessian would not fit one
  card still solves;
* the node states, the CG vectors, their dot products and the step are
  replicated: every rank computes them alike from the reduced sums.

Every iteration count is fixed (``gn_iterations`` x ``cg_iterations``, as
JAX's ``lax.scan``): the data-dependent choices are ``torch.where``, so no
step reads the device from the host. A step is kept only if it lowered
chi2. With ``mesh=None`` it runs on one device, an exact matrix-free GN-CG
solver. Sharded results match the one-device run to the reduction order,
not bit for bit (the sums over factors are split at other places).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import lie
from ..nlls import factor_graph as fg
from . import group as group_mod


@dataclasses.dataclass(frozen=True)
class DistributedPGOOptions:
    gn_iterations: int = 10
    cg_iterations: int = 50
    cg_tol: float = 1e-6      # kept for parity: the JAX solver runs fixed CG


def _sum_all(ts, mesh):
    """Several sums over the ranks in one all-reduce (flattened and split
    back)."""
    if mesh is None:
        return ts
    flat = group_mod.all_sum(torch.cat([t.reshape(-1) for t in ts]), mesh)
    out, k = [], 0
    for t in ts:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return out


def _apply_J(graph: fg.SE2Graph, lin, v):
    """J v from the Jacobian blocks ``lin`` of :func:`fg._linearize`: the
    prior rows, then the between rows, flattened (the JAX package's
    residual order)."""
    _, pJ, _, bJi, bJj = lin
    d = v.reshape(-1, 3)
    jp = torch.einsum("fab,fb->fa", pJ, d[graph.prior_idx])
    jb = (torch.einsum("fab,fb->fa", bJi, d[graph.bet_i])
          + torch.einsum("fab,fb->fa", bJj, d[graph.bet_j]))
    return torch.cat([jp.reshape(-1), jb.reshape(-1)])


def _apply_JT(graph: fg.SE2Graph, lin, r, n: int):
    """J^T r over this rank's factors (a sum over factors)."""
    _, pJ, _, bJi, bJj = lin
    n_p = pJ.shape[0]
    rp, rb = r[:3 * n_p].reshape(-1, 3), r[3 * n_p:].reshape(-1, 3)
    g = torch.zeros((n, 3), dtype=r.dtype, device=r.device)
    g.index_add_(0, graph.prior_idx, torch.einsum("fab,fa->fb", pJ, rp))
    g.index_add_(0, graph.bet_i, torch.einsum("fab,fa->fb", bJi, rb))
    g.index_add_(0, graph.bet_j, torch.einsum("fab,fa->fb", bJj, rb))
    return g.reshape(-1)


def _block_jacobi(graph: fg.SE2Graph, lin, n: int):
    """This rank's share of the per-node 3x3 diagonal blocks of H = J^T J
    (a sum over factors)."""
    _, pJ, _, bJi, bJj = lin
    blocks = torch.zeros((n, 3, 3), dtype=pJ.dtype, device=pJ.device)
    blocks.index_add_(0, graph.prior_idx, fg._jtj(pJ, pJ))
    blocks.index_add_(0, graph.bet_i, fg._jtj(bJi, bJi))
    blocks.index_add_(0, graph.bet_j, fg._jtj(bJj, bJj))
    return blocks


def _inv3(a):
    """Closed-form batched 3x3 inverse (a singular block gives its
    adjugate)."""
    c00 = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
    c01 = a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2]
    c02 = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
    det = a[:, 0, 0] * c00 + a[:, 0, 1] * c01 + a[:, 0, 2] * c02
    det = torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))
    adj = torch.stack([
        torch.stack([c00,
                     a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2],
                     a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]], -1),
        torch.stack([c01,
                     a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0],
                     a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2]], -1),
        torch.stack([c02,
                     a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1],
                     a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]], -1),
    ], -2)
    return adj / det[:, None, None]


def _chi2(nodes, graph: fg.SE2Graph):
    """This rank's share of chi2, from the residual function."""
    pr, br = fg._residuals(nodes, graph)
    r = torch.cat([pr.reshape(-1), br.reshape(-1)])
    return torch.sum(r * r)


def optimize_distributed(nodes, graph: fg.SE2Graph, active_mask,
                         opts: DistributedPGOOptions = DistributedPGOOptions(),
                         mesh=None):
    """Matrix-free GN-CG with block-Jacobi preconditioning.

    ``nodes`` f32 [N, 4] (replicated), ``graph`` this rank's factors
    (:func:`shard_graph`; the whole graph with ``mesh=None``),
    ``active_mask`` bool [N]. ``mesh`` is the process group the factors
    are split over. Returns (nodes, {"chi2_history": f32
    [gn_iterations]}), the chi2 before each step."""
    n = nodes.shape[0]
    act = active_mask.to(nodes.dtype).reshape(-1, 1)
    # the identity on inactive padding nodes and 1e-6 on every diagonal
    eye = torch.eye(3, dtype=nodes.dtype, device=nodes.device)
    damp = ((~active_mask).to(nodes.dtype)[:, None, None] + 1e-6) * eye
    chi2s = []
    for _ in range(opts.gn_iterations):
        lin = fg._linearize(nodes, graph)
        pr, _, br, _, _ = lin
        r0 = torch.cat([pr.reshape(-1), br.reshape(-1)])
        # chi2 from the residual function, as after the step: a kept step
        # lowers the history, a refused one repeats its entry exactly; the
        # three sums over factors in one all-reduce
        chi2, g, blocks = _sum_all(
            [_chi2(nodes, graph), _apply_JT(graph, lin, r0, n),
             _block_jacobi(graph, lin, n)], mesh)
        pre = _inv3(blocks + damp)

        def precond(v):
            return torch.einsum("nab,nb->na", pre, v.reshape(n, 3)).reshape(-1)

        def hvp(v):
            return group_mod.all_sum(_apply_JT(graph, lin, _apply_J(graph, lin, v), n),
                        mesh)

        # preconditioned CG on H delta = -g
        r = -g
        x = torch.zeros_like(r)
        z = precond(r)
        p = z
        rz = torch.dot(r, z)
        zero = torch.zeros_like(rz)
        for _ in range(opts.cg_iterations):
            hp = hvp(p)
            denom = torch.dot(p, hp)
            alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, zero)
            x = x + alpha * p
            r = r - alpha * hp
            z = precond(r)
            rz_new = torch.dot(r, z)
            beta = torch.where(rz > 1e-20, rz_new / rz, zero)
            p = z + beta * p
            rz = rz_new
        delta = x.reshape(n, 3) * act
        new_nodes = lie.se2_compose(nodes, lie.se2_exp(delta))
        better = group_mod.all_sum(_chi2(new_nodes, graph), mesh) < chi2
        nodes = torch.where(better, new_nodes, nodes)
        chi2s.append(chi2)
    return nodes, {"chi2_history": torch.stack(chi2s)}


def shard_graph(graph: fg.SE2Graph, mesh) -> fg.SE2Graph:
    """This rank's slice of the factor axis (the priors and the betweens
    each split evenly over the ranks; ``GraphBuilder`` pads both to
    multiples of 64)."""
    sp = group_mod.rows(graph.prior_idx.shape[0], mesh)
    sb = group_mod.rows(graph.bet_i.shape[0], mesh)
    return fg.SE2Graph(*(a[sp].clone() for a in graph[:4]),
                       *(a[sb].clone() for a in graph[4:]))
