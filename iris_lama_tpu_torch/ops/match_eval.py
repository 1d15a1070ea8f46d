"""The math of one fused Gauss-Newton evaluation (kernel B5's).

From the four corners of a squared-distance grid at each beam, the
bilinear distance and gradient, the beam mask and the Cauchy weight give
the ten sums of the normal equations: ``A = Jw'Jw`` (6), ``g = Jw'rw``
(3) and ``chi2 = rw'rw``. The JAX package's ``ops/match_eval.py`` fuses
them into one Pallas launch per evaluation (B5, off by default there);
its ``_eval_math`` is shared with the batched whole solve B6
(``ops/gn_batch.py``). This is that function on tensors: beams on the last
axis, any leading (particle) axes; ``csrc/gn_batch.cu`` repeats it
statement for statement. Corner selection is B2's function
(``ops/select4.py``). The B5 kernel itself is not ported yet.
"""

from __future__ import annotations

import torch

from ..sdm.geometry import f32

def _eval_math(ly, lx, v00i, v10i, v01i, v11i, mux, muy, hx, hy, fm,
               h, w, max_dist, res, scale, cauchy_c, total=None):
    """Everything after corner selection: a tuple of the ten sums over
    the last (beam) axis, each taken by ``total`` (``torch.sum`` over the
    last axis by default).

    Mirrors the JAX package's ``_interp_window_sq`` + ``make_window_eval``
    + ``solver._weighted`` term for term: an out-of-range corner reads
    ``max_dist``; ``cauchy_c <= 0`` selects unit weights.
    """
    md = f32(max_dist)
    resf = f32(res)

    def corner(s, ok):
        return torch.where(ok, torch.sqrt(s.to(torch.float32)) * resf, md)

    def inx(v):
        return (v >= 0) & (v < w)

    def iny(v):
        return (v >= 0) & (v < h)

    v00 = corner(v00i, inx(lx) & iny(ly))
    v10 = corner(v10i, inx(lx + 1) & iny(ly))
    v01 = corner(v01i, inx(lx) & iny(ly + 1))
    v11 = corner(v11i, inx(lx + 1) & iny(ly + 1))

    mix, miy = 1.0 - mux, 1.0 - muy
    dist = (v00 * mix * miy + v10 * miy * mux +
            v01 * mix * muy + v11 * mux * muy)
    scl = f32(scale)
    gx_ = -((v00 - v10) * miy + (v01 - v11) * muy) * scl
    gy_ = -((v00 - v01) * mix + (v10 - v11) * mux) * scl

    r = dist * fm
    gx = gx_ * fm
    gy = gy_ * fm
    jw = gy * hx - gx * hy

    if cauchy_c > 0.0:
        cinv = f32(1.0 / (cauchy_c * cauchy_c))
        wgt = 1.0 / (1.0 + r * r * cinv)
    else:
        wgt = torch.ones_like(r)
    sw = torch.sqrt(wgt)
    rw = r * sw
    gxw = gx * sw
    gyw = gy * sw
    jww = jw * sw

    if total is None:
        def total(x):
            return torch.sum(x, dim=-1)

    return (total(gxw * gxw), total(gxw * gyw), total(gxw * jww),
            total(gyw * gyw), total(gyw * jww), total(jww * jww),
            total(gxw * rw), total(gyw * rw), total(jww * rw),
            total(rw * rw))
