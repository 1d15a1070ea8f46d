"""B5: one fused Gauss-Newton evaluation — the ten normal-equation sums.

From the four corners of a squared-distance grid at each beam, the
bilinear distance and gradient, the beam mask and the Cauchy weight give
the ten sums of the normal equations: ``A = Jw'Jw`` (6), ``g = Jw'rw``
(3) and ``chi2 = rw'rw``. :func:`_eval_math` is that arithmetic on
tensors (beams on the last axis, any leading particle axes); the
whole-solve kernels B4 and B6 (``ops/gn_solve.py``, ``ops/gn_batch.py``)
repeat it per evaluation.

The TPU kernel (iris_lama_tpu/ops/match_eval.py:_kernel) selected the
corners with a one-hot matrix product and reduced in VMEM. On the GPU it is
one CUDA kernel (``csrc/match_eval.cu``) that runs the evaluation of the
whole-solve kernels B4/B6 (``csrc/gn_common.cuh``): one block of
``256 * Q`` threads per particle (one beam a thread at 768 beams), the
sums in the order of :func:`_block_sum`, each beam operand read through its
strides (views such as ``loc[..., 1]`` pass as they are), one
instantiation per squared-distance width (int8, uint8, int16, int32). Up
to :data:`REGISTER_BEAMS` beams a thread keeps its beams in registers;
beyond that the summing threads read their further beams' operands in the
same order. :func:`gn_eval_sq` launches it for CUDA tensors;
:func:`gn_eval_sq_plain` — B2's plain corners, :func:`_eval_math` and the
block-order sum — is its plain version, bit-equal on the card, and runs
for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..sdm.geometry import f32
from . import _cuda, select4

N_OUT = 10   # a00 a01 a02 a11 a12 a22 g0 g1 g2 chi2
# csrc/gn_common.cuh: summation lanes (logical threads) of a block, warp
THREADS, LANES = 256, 32
REGISTER_BEAMS = 2048   # csrc/gn_common.cuh: 256 lanes x kMaxPT beams


def _block_sum(x):
    """Sum over the last (beam) axis in the order of the kernels' block
    reduction (csrc/gn_common.cuh), so that a plain version and its kernel
    add the same float32 values in the same order: thread ``t`` adds beams
    ``t``, ``t + 256``, ... in turn; each warp of 32 threads halves by
    shuffle-down (lane ``i`` adds lane ``i + 16``, then ``i + 8``, ...
    ``i + 1``); thread 0 adds the eight warp totals in turn."""
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


def gn_eval_sq_plain(grid, ly, lx, mux, muy, hx, hy, fm, *, max_dist, res,
                     scale, cauchy_c):
    """Plain PyTorch version of :func:`gn_eval_sq`: B2's plain corners,
    :func:`_eval_math` and the kernel's summation order."""
    h, w = grid.shape[-2:]
    v = select4.select4_sq_plain(grid, ly, lx)
    sums = _eval_math(ly, lx, v[0], v[1], v[2], v[3], mux, muy, hx, hy, fm,
                      h, w, max_dist, res, scale, cauchy_c, total=_block_sum)
    return torch.stack(sums, dim=-1)


def gn_eval_sq(grid, ly, lx, mux, muy, hx, hy, fm, *, max_dist, res, scale,
               cauchy_c):
    """f32 GN normal-equation sums (a00, a01, a02, a11, a12, a22, g0, g1,
    g2, chi2) from a squared-distance window (int8, uint8, int16 or
    int32): grid ``[H, W]`` with
    beam operands ``[B]`` gives ``[10]``; grids ``[P, H, W]`` with operands
    ``[P, B]`` give ``[P, 10]``. ``ly``, ``lx`` are int32 window-local
    cells, ``mux``, ``muy`` their fractions, ``hx``, ``hy`` the hits and
    ``fm`` the float mask; ``cauchy_c <= 0`` selects unit weights.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (a contiguous grid, beam operands of these dtypes and shapes in any
    layout, any number of beams) or raise.
    """
    kw = dict(max_dist=max_dist, res=res, scale=scale, cauchy_c=cauchy_c)
    if grid.device.type == "cpu":
        return gn_eval_sq_plain(grid, ly, lx, mux, muy, hx, hy, fm, **kw)
    dev = grid.device
    batched = grid.dim() == 3
    nd = 2 if batched else 1
    _cuda.require(grid, "grid", None, nd + 1, dev)
    code = _cuda.sq_code(grid, "grid")
    ops = dict(ly=ly, lx=lx, mux=mux, muy=muy, hx=hx, hy=hy, fm=fm)
    strides = []
    for name, t in ops.items():
        dt = torch.int32 if name in ("ly", "lx") else torch.float32
        st = _cuda.require_strided(t, name, dt, nd, dev)
        if t.shape != ly.shape or (batched and t.shape[0] != grid.shape[0]):
            raise ValueError(f"gn_eval_sq: grid {tuple(grid.shape)}, {name} "
                             f"{tuple(t.shape)}, ly {tuple(ly.shape)}")
        strides += st if batched else (0, *st)   # (particles, beams)
    b = ly.shape[-1]
    p = grid.shape[0] if batched else 1
    h, w = grid.shape[-2:]
    robust = float(cauchy_c) > 0.0
    cinv = f32(1.0 / (cauchy_c * cauchy_c)) if robust else 0.0
    out = torch.empty((p, N_OUT), dtype=torch.float32, device=dev)
    lib = _cuda.library("match_eval")
    _cuda.check(lib.gn_eval_sq(
        grid.data_ptr(), code, p, h, w,
        *(t.data_ptr() for t in ops.values()),
        (ctypes.c_int64 * len(strides))(*strides), b, f32(max_dist),
        f32(res), f32(scale), cinv, int(robust), out.data_ptr(),
        _cuda.stream_handle(dev)), "gn_eval_sq")
    return out if batched else out[0]
