"""Scalar helpers of the whole-solve Gauss-Newton step (kernel B4's).

The JAX package's ``ops/gn_solve.py`` runs the whole IRLS solve of one
particle in one Pallas launch (B4, off by default there); its scalar step
— the 3x3 adjugate solve and the SE(2) exp-compose update — is shared with
the batched solve B6 (``ops/gn_batch.py``). These are those helpers on
tensors of any (equal) shape, elementwise, in float32 and in the JAX
package's order of operations; ``csrc/gn_batch.cu`` repeats them
statement for statement. The B4 kernel itself is not ported yet.
"""

from __future__ import annotations

import torch

from ..sdm.geometry import f32


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
