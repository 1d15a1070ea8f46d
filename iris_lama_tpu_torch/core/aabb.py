"""Axis-aligned bounding boxes.

reference: include/lama/aabb.h:41-75 — center/half-width box with an
intersection test, used by transient maps (src/slam2d.cpp:323-373).
Vectorized: works on single boxes or batches. numpy only.
"""

from __future__ import annotations

import numpy as np


class AABB:
    """Center + half-width box (aabb.h:41-55)."""

    def __init__(self, min_pt, max_pt):
        min_pt = np.asarray(min_pt, np.float64)
        max_pt = np.asarray(max_pt, np.float64)
        self.center = 0.5 * (min_pt + max_pt)
        self.hwidth = 0.5 * np.abs(max_pt - min_pt)

    def test_intersection(self, other: "AABB") -> bool:
        """aabb.h:57-71."""
        sep = np.abs(self.center - other.center)
        return bool(np.all(sep <= self.hwidth + other.hwidth))

    def contains(self, point) -> bool:
        sep = np.abs(np.asarray(point, np.float64) - self.center)
        return bool(np.all(sep <= self.hwidth))


def batch_intersects(centers_a, hwidths_a, center_b, hwidth_b):
    """bool[N]: which of N boxes intersect box b (numpy arrays or tensors,
    broadcast; the transient-map prune test)."""
    sep = abs(centers_a - center_b)
    return (sep <= (hwidths_a + hwidth_b)).all(axis=-1)
