"""Occupancy models: the simple tri-state map and the log-odds update.

reference: include/lama/sdm/occupancy_map.h:43-77 and
src/sdm/simple_occupancy_map.cpp — an int8 cell per map cell, -1 free,
0 unknown, +1 occupied. Loc2D reads it as a fixed input (loc2d.h:103-104):
global localisation draws its hypotheses from free cells.

The probabilistic model's constants and its per-scan log-odds update
(src/sdm/probabilistic_occupancy_map.cpp:51-59, 82-107) serve the fused
SLAM map of ``sdm/mapping.py`` (``occ_model="probabilistic"``). The
standalone frequency and probabilistic map states of the JAX package
(``iris_lama_tpu/sdm/occupancy.py``) are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import pool as pool_mod


def _logodds(p: float) -> float:
    return math.log(p / (1.0 - p))


# Probabilistic constants (probabilistic_occupancy_map.cpp:51-59), Python
# doubles applied in float32 arithmetic, as in the JAX package
PROB_MISS = _logodds(0.4)
PROB_HIT = _logodds(0.7)
PROB_CLAMP_MIN = _logodds(0.12)
PROB_CLAMP_MAX = _logodds(0.97)


def probabilistic_saturate(lo, hit_counts, miss_counts):
    """Per-visit-clamped log-odds update from a scan's counts.

    The reference clamps after every visit, one-sided (setOccupied at
    clamp_max, setFree at clamp_min). For a run of hits (or of misses)
    that has the closed form ``min(x + h*HIT, cmax)`` (``max(x + m*MISS,
    cmin)``); a cell with both takes all its hits, then all its misses
    (the reference's per-beam order: the endpoint before the beam's ray).
    ``lo`` stays within [cmin, cmax], so untouched cells do not change.
    float32 throughout, in the JAX package's operation order.
    """
    h = hit_counts.to(torch.float32)
    m = miss_counts.to(torch.float32)
    lo = torch.clamp(lo + h * PROB_HIT, max=PROB_CLAMP_MAX)
    return torch.clamp(lo + m * PROB_MISS, min=PROB_CLAMP_MIN)


class SimpleOccupancyState(NamedTuple):
    table: pool_mod.PatchTable
    cells: torch.Tensor   # int8 [P+1, L, L]: -1 free / 0 unknown / +1 occupied


def _cells_are(state: SimpleOccupancyState, geo, cells, value: int,
               missing: bool):
    slots, idx = pool_mod.locate(state.table, geo, cells,
                                 state.cells.shape[0] - 1)
    hit = state.cells[idx] == value
    return torch.where(slots >= 0, hit, missing)


def simple_is_free(state: SimpleOccupancyState, geo, cells):
    return _cells_are(state, geo, cells, -1, False)


def simple_is_occupied(state: SimpleOccupancyState, geo, cells):
    return _cells_are(state, geo, cells, 1, False)


def simple_is_unknown(state: SimpleOccupancyState, geo, cells):
    return _cells_are(state, geo, cells, 0, True)
