"""B1: unit-count deposit (the raycast's free-space and hit counts).

``counts[y, x] = #{t : (ly_t, lx_t) == (y, x)}`` over int32 index streams;
elements outside ``[0, h) x [0, w)`` count nothing (callers route
masked-out cells to the sentinel row ``ly == h``).

Streams ``[N]`` give one grid ``[h, w]``; streams ``[P, N]`` give one grid
per particle, ``[P, h, w]`` (the vmap batch rule of the JAX package's
``scatter_counts_2d``). An element of particle ``p`` counts only in grid
``p``: a sentinel never spills into the next particle's grid.
:func:`deposit_pair` makes a scan's two deposits at once: ``occ_add``, the
hit counts, and ``vis_add = occ_add + free-space counts`` (the map
update's two grids, ``sdm/mapping.py``).

The TPU version (iris_lama_tpu/ops/scatter_matmul.py) computed this as a
one-hot contraction on the matrix unit, exact only for beam-major input
plus an XLA fix-up. On the GPU it is one CUDA kernel of integer atomics
(``csrc/deposit.cu``), exact for any input order: one memset and one
launch a call, every stream of the call in blocks of :data:`BLOCK_ELEMS`
elements. :func:`deposit_counts` and :func:`deposit_pair` launch it for
CUDA tensors and use their plain versions for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda

# csrc/deposit.cu: threads a block, elements a block
THREADS, BLOCK_ELEMS = 256, 512


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


def deposit_pair_plain(hit_ly, hit_lx, free_ly, free_lx, h: int, w: int):
    """Plain PyTorch version of :func:`deposit_pair`: two
    :func:`deposit_counts_plain` calls and an add."""
    occ = deposit_counts_plain(hit_ly, hit_lx, h, w)
    return occ, occ + deposit_counts_plain(free_ly, free_lx, h, w)


def _check_stream(ly, lx, dev, ndim, name: str) -> None:
    _cuda.require(ly, f"{name}ly", torch.int32, ndim, dev)
    _cuda.require(lx, f"{name}lx", torch.int32, ndim, dev)
    if ly.shape != lx.shape:
        raise ValueError(f"{name}ly {tuple(ly.shape)} and {name}lx "
                         f"{tuple(lx.shape)} differ in shape")


def launch_blocks(p: int, lengths) -> int:
    """Blocks of one launch over ``p`` particles of streams of ``lengths``
    elements a particle (csrc/deposit.cu: make_stream)."""
    return p * sum(-(-n // BLOCK_ELEMS) for n in lengths)


def deposit_counts(ly, lx, h: int, w: int):
    """int32 unit counts of the int32 index streams ``ly``, ``lx``:
    ``[N]`` -> ``[h, w]``, or ``[P, N]`` -> ``[P, h, w]``, in any order.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous int32 streams of equal shape) or raise.
    """
    if ly.device.type == "cpu" and lx.device.type == "cpu":
        return deposit_counts_plain(ly, lx, h, w)
    dev = ly.device
    ndim = ly.dim()
    if ndim not in (1, 2):
        raise ValueError(f"ly: expected 1 or 2 dims, got {ndim}")
    _check_stream(ly, lx, dev, ndim, "")
    p = ly.shape[0] if ndim == 2 else 1
    n = ly.shape[-1]
    out = torch.empty((p, h, w), dtype=torch.int32, device=dev)
    lib = _cuda.library("deposit")
    _cuda.check(lib.deposit_counts(ly.data_ptr(), lx.data_ptr(), n, p, h, w,
                                   out.data_ptr(), _cuda.stream_handle(dev)),
                "deposit_counts")
    return out if ndim == 2 else out[0]


def deposit_pair(hit_ly, hit_lx, free_ly, free_lx, h: int, w: int):
    """A scan's two deposits: ``(occ_add, vis_add)``, the hit counts and
    ``occ_add`` plus the free-space counts, each ``[h, w]`` for streams
    ``[N]`` or ``[P, h, w]`` for streams ``[P, N]`` (hit and free streams
    of one rank and particle count).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one memset, one launch) or raise.
    """
    if all(t.device.type == "cpu" for t in (hit_ly, hit_lx, free_ly,
                                            free_lx)):
        return deposit_pair_plain(hit_ly, hit_lx, free_ly, free_lx, h, w)
    dev = hit_ly.device
    ndim = hit_ly.dim()
    if ndim not in (1, 2):
        raise ValueError(f"hit_ly: expected 1 or 2 dims, got {ndim}")
    _check_stream(hit_ly, hit_lx, dev, ndim, "hit_")
    _check_stream(free_ly, free_lx, dev, ndim, "free_")
    p = hit_ly.shape[0] if ndim == 2 else 1
    if ndim == 2 and free_ly.shape[0] != p:
        raise ValueError(f"hit streams {tuple(hit_ly.shape)} and free "
                         f"streams {tuple(free_ly.shape)}: particles differ")
    nh, nf = hit_ly.shape[-1], free_ly.shape[-1]
    out = torch.empty((2, p, h, w), dtype=torch.int32, device=dev)
    lib = _cuda.library("deposit")
    _cuda.check(lib.deposit_pair(hit_ly.data_ptr(), hit_lx.data_ptr(), nh,
                                 free_ly.data_ptr(), free_lx.data_ptr(), nf,
                                 p, h, w, out.data_ptr(),
                                 _cuda.stream_handle(dev)),
                "deposit_pair")
    return (out[0], out[1]) if ndim == 2 else (out[0, 0], out[1, 0])
