"""B1: unit-count deposit (the raycast's free-space and hit counts).

``counts[y, x] = #{t : (ly_t, lx_t) == (y, x)}`` over int32 index streams;
elements outside ``[0, h) x [0, w)`` count nothing (callers route
masked-out cells to the sentinel row ``ly == h``).

Streams ``[N]`` give one grid ``[h, w]``; streams ``[P, N]`` give one grid
per particle, ``[P, h, w]`` (the vmap batch rule of the JAX package's
``scatter_counts_2d``). An element of particle ``p`` counts only in grid
``p``: a sentinel never spills into the next particle's grid.

The TPU version (iris_lama_tpu/ops/scatter_matmul.py) computed this as a
one-hot contraction on the matrix unit, exact only for beam-major input
plus an XLA fix-up. On the GPU it is a CUDA kernel of integer atomics
(``csrc/deposit.cu``), exact for any input order. :func:`deposit_counts`
launches it for CUDA tensors and uses :func:`deposit_counts_plain` for CPU
tensors.
"""

from __future__ import annotations

import torch

from . import _cuda


def deposit_counts_plain(ly, lx, h: int, w: int):
    """Plain PyTorch version: ``index_add_`` of ones, with every invalid
    element sent to one extra bin per particle that is dropped."""
    p = ly.shape[0] if ly.dim() == 2 else 1
    ok = (ly >= 0) & (ly < h) & (lx >= 0) & (lx < w)
    flat = torch.where(ok, ly.long() * w + lx.long(), h * w)
    flat = flat.reshape(p, -1) + (h * w + 1) * torch.arange(
        p, device=ly.device)[:, None]
    counts = torch.zeros(p * (h * w + 1), dtype=torch.int32, device=ly.device)
    counts.index_add_(0, flat.reshape(-1),
                      torch.ones(flat.numel(), dtype=torch.int32,
                                 device=ly.device))
    counts = counts.reshape(p, h * w + 1)[:, :h * w].reshape(p, h, w)
    return counts if ly.dim() == 2 else counts[0]


def deposit_counts(ly, lx, h: int, w: int):
    """int32 unit counts of the int32 index streams ``ly``, ``lx``:
    ``[N]`` -> ``[h, w]``, or ``[P, N]`` -> ``[P, h, w]``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous int32 streams of equal shape) or raise.
    """
    if ly.device.type == "cpu" and lx.device.type == "cpu":
        return deposit_counts_plain(ly, lx, h, w)
    dev = ly.device
    ndim = ly.dim()
    if ndim not in (1, 2):
        raise ValueError(f"ly: expected 1 or 2 dims, got {ndim}")
    _cuda.require(ly, "ly", torch.int32, ndim, dev)
    _cuda.require(lx, "lx", torch.int32, ndim, dev)
    if ly.shape != lx.shape:
        raise ValueError(f"ly {tuple(ly.shape)} and lx {tuple(lx.shape)} "
                         "differ in shape")
    p = ly.shape[0] if ndim == 2 else 1
    out = torch.empty((p, h, w), dtype=torch.int32, device=dev)
    lib = _cuda.library("deposit")
    _cuda.check(lib.deposit_counts(ly.data_ptr(), lx.data_ptr(),
                                   ly.shape[-1], p, h, w, out.data_ptr(),
                                   _cuda.stream_handle(dev)),
                "deposit_counts")
    deposit_counts.launches += 1
    return out if ndim == 2 else out[0]


deposit_counts.launches = 0
