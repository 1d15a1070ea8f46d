"""Loop-free raycasting: the reference's integer ray walk in closed form.

reference: src/sdm/map.cpp:198-258 ``computeRay`` — an error-accumulation
max-coordinate walk visiting cells t = 1..n-1 (n = max |delta|; start and
hit cells excluded). After ``t`` steps axis ``j`` has advanced

    c_j(t) = (2*t*|delta_j| + n) // (2*n)

cells, so every cell of every ray is computed independently with one exact
integer floor division.
"""

from __future__ import annotations

import torch


def ray_cells(from_cells, to_cells, max_steps: int):
    """All intermediate cells of each ray.

    from_cells, to_cells: int32[B, D] start and end (hit) cells, in any
    dimension D (2 for the 2D maps, 3 for the 3D ones).
    max_steps: bound T on cells per ray (longer rays are truncated).
    Returns (cells int32[B, T, D] for t = 1..T, mask bool[B, T] — True
    where t <= n - 1).
    """
    f = from_cells.to(torch.int32)
    d = to_cells.to(torch.int32) - f                           # [B, D]
    step = torch.sign(d)
    ad = torch.abs(d)
    n = ad.amax(dim=-1)                                         # [B]
    n_safe = torch.clamp(n, min=1)
    t = torch.arange(1, max_steps + 1, dtype=torch.int32, device=f.device)
    num = 2 * t[None, :, None] * ad[:, None, :] + n_safe[:, None, None]
    den = 2 * n_safe[:, None, None]
    c = torch.div(num, den, rounding_mode="floor")             # [B, T, D]
    cells = f[:, None, :] + step[:, None, :] * c
    mask = t[None, :] <= (n[:, None] - 1)
    return cells, mask
