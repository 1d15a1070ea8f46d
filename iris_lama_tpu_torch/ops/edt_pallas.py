"""B3: exact capped squared Euclidean distance transform.

``edt2d(obstacle, max_sqdist, radius)``: bool ``[H, W]`` -> int32 ``[H, W]``,
the squared distance to the nearest obstacle within the cap radius,
clipped to ``max_sqdist``; cells outside the grid are not obstacles. A
vertical pass takes each cell's capped ``|dy|`` (at most ``radius + 1``),
a horizontal pass ``min over |dx| <= radius of dx^2 + g^2``. A mask
``[P, H, W]`` gives one transform per particle (the JAX package vmaps
``distance.edt2d``).

The TPU twin (iris_lama_tpu/ops/edt_pallas.py) ran both passes as strip
kernels in VMEM. On the GPU (``csrc/edt.cu``), up to :data:`MAX_RADIUS`
cells, one fused CUDA kernel: a block per 32 x 64 output tile copies its
mask tile with an ``R``-cell halo into shared memory and runs both passes
there, the capped ``|dy|`` kept as uint8, so nothing but the mask and the
result crosses device memory. A larger radius (any, ``R + 1 > 255``
included) takes two launches of the same call: a column sweep into an
int32 scratch grid, then a direct row min. :func:`edt2d` uses
:func:`edt2d_plain` — the shift-and-min passes of ``sdm/distance.py:edt2d``
of the JAX package — for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda

# csrc/edt.cu: kMaxRadius (3.2 m at 5 cm cells), the largest the shared-
# memory tile takes; beyond it the two-launch kernel
MAX_RADIUS = 64


def edt2d_plain(obstacle, max_sqdist: int, radius: int):
    """Plain PyTorch version: log-doubling min-plus erosion for the
    vertical pass, ``radius`` shift-and-min rounds for the horizontal.
    Any ``radius >= 0``: a shift of H rows or more, or of W columns or
    more, brings in only padding, which changes nothing after the final
    clamp, so those rounds are skipped. Leading dimensions are batch."""
    *lead, h, w = obstacle.shape
    dev = obstacle.device
    big_g = radius + 1
    g = torch.where(obstacle, 0, big_g).to(torch.int32)
    shift = 1
    while shift <= radius and shift < h:
        pad = torch.full((*lead, shift, w), big_g, dtype=torch.int32,
                         device=dev)
        up = torch.cat([g[..., shift:, :], pad], dim=-2)
        down = torch.cat([pad, g[..., :-shift, :]], dim=-2)
        g = torch.minimum(g, torch.minimum(up, down) + shift)
        g = torch.clamp(g, max=big_g)
        shift <<= 1
    g2 = g * g
    d2 = g2
    for dx in range(1, min(radius, w - 1) + 1):
        padc = torch.full((*lead, h, dx), max_sqdist, dtype=torch.int32,
                          device=dev)
        left = torch.cat([g2[..., dx:], padc], dim=-1)
        right = torch.cat([padc, g2[..., :-dx]], dim=-1)
        d2 = torch.minimum(d2, torch.minimum(left, right) + dx * dx)
    return torch.clamp(d2, max=max_sqdist)


def edt2d(obstacle, max_sqdist: int, radius: int):
    """int32 capped squared EDT of the bool mask ``obstacle``, ``[H, W]``
    or ``[P, H, W]``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous bool mask) or raise. Any ``radius >= 0``; a negative one
    raises on every device.
    """
    if radius < 0:
        raise ValueError(f"edt2d: radius {radius}: expected radius >= 0")
    if obstacle.device.type == "cpu":
        return edt2d_plain(obstacle, max_sqdist, radius)
    dev = obstacle.device
    ndim = obstacle.dim()
    if ndim not in (2, 3):
        raise ValueError(f"obstacle: expected 2 or 3 dims, got {ndim}")
    _cuda.require(obstacle, "obstacle", torch.bool, ndim, dev)
    *lead, h, w = obstacle.shape
    p = lead[0] if lead else 1
    out = torch.empty((p, h, w), dtype=torch.int32, device=dev)
    scratch = (torch.empty((p, h, w), dtype=torch.int32, device=dev)
               if radius > MAX_RADIUS else None)
    lib = _cuda.library("edt")
    _cuda.check(lib.edt2d(obstacle.data_ptr(), p, h, w, radius, max_sqdist,
                          None if scratch is None else scratch.data_ptr(),
                          out.data_ptr(), _cuda.stream_handle(dev)),
                "edt2d")
    return out if lead else out[0]
