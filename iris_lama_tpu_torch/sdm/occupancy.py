"""Standalone pool-backed occupancy maps: the simple tri-state map.

reference: include/lama/sdm/occupancy_map.h:43-77 and
src/sdm/simple_occupancy_map.cpp — an int8 cell per map cell, -1 free,
0 unknown, +1 occupied. Loc2D reads it as a fixed input (loc2d.h:103-104):
global localisation draws its hypotheses from free cells. The frequency
and probabilistic standalone maps of the JAX package
(``iris_lama_tpu/sdm/occupancy.py``) are not ported yet; the SLAM path
keeps its counts in ``sdm/mapping.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import pool as pool_mod


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
