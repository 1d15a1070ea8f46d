"""Standalone occupancy maps (pool-backed): simple, frequency, probabilistic.

reference: include/lama/sdm/occupancy_map.h:43-77 and the three concrete
maps:

* SimpleOccupancyMap — a tri-state int8 cell, -1 free, 0 unknown, +1
  occupied (src/sdm/simple_occupancy_map.cpp);
* FrequencyOccupancyMap — {occupied, visited} uint16 counts, occupied iff
  occ/vis > 0.25 (src/sdm/frequency_occupancy_map.cpp:38-45);
* ProbabilisticOccupancyMap — float log-odds with per-visit clamping
  (src/sdm/probabilistic_occupancy_map.cpp:38-59, 82-107).

These states are the maps used as inputs (Loc2D reads a simple map and a
distance map, loc2d.h:103-104) and the maps read and written as ``.smd``
files (``sdm/io.py``). The SLAM drivers update the fused map of
``sdm/mapping.py``, whose probabilistic model uses
:func:`probabilistic_saturate` below.

Updates are per-call aggregates: counts are scatter-added, then the
end state follows (the frequency map's end state equals the reference's
sequential ``set*`` calls; the probabilistic map's equals them in the
canonical per-cell order of :func:`probabilistic_saturate`).

Frequency counts: PyTorch's uint16 has no addition or ``index_put``, so
the frequency state holds its uint16 counts in int32 and wraps every sum
mod 2**16, as the JAX package's uint16 addition does (the fused SLAM map
clips at 65535 instead, as the JAX package's does there).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from . import pool as pool_mod
from .geometry import MapGeometry, f32

OCC_THRESH = 0.25  # frequency_occupancy_map.cpp:38
U16_MASK = 0xFFFF


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


@dataclasses.dataclass(frozen=True)
class OccupancyConfig:
    geometry: MapGeometry = MapGeometry()
    capacity: int = 4096


class SimpleOccupancyState(NamedTuple):
    table: pool_mod.PatchTable
    cells: torch.Tensor   # int8 [P+1, L, L]: -1 free / 0 unknown / +1 occupied


class ProbabilisticOccupancyState(NamedTuple):
    table: pool_mod.PatchTable
    logodds: torch.Tensor   # f32 [P+1, L, L]
    touched: torch.Tensor   # bool [P+1, L, L]: cell ever written (unknown)


class FrequencyOccupancyState(NamedTuple):
    table: pool_mod.PatchTable
    occupied: torch.Tensor  # int32 [P+1, L, L] (uint16 values)
    visited: torch.Tensor   # int32 [P+1, L, L] (uint16 values)


def _zeros(cfg: OccupancyConfig, dtype, device):
    length = cfg.geometry.patch_length
    return torch.zeros((cfg.capacity + 1, length, length), dtype=dtype,
                       device=device)


def simple_init(cfg: OccupancyConfig, device=None) -> SimpleOccupancyState:
    return SimpleOccupancyState(
        pool_mod.table_init(cfg.capacity, device=device),
        _zeros(cfg, torch.int8, device))


def probabilistic_init(cfg: OccupancyConfig,
                       device=None) -> ProbabilisticOccupancyState:
    return ProbabilisticOccupancyState(
        pool_mod.table_init(cfg.capacity, device=device),
        _zeros(cfg, torch.float32, device), _zeros(cfg, torch.bool, device))


def frequency_init(cfg: OccupancyConfig,
                   device=None) -> FrequencyOccupancyState:
    return FrequencyOccupancyState(
        pool_mod.table_init(cfg.capacity, device=device),
        _zeros(cfg, torch.int32, device), _zeros(cfg, torch.int32, device))


# ---------------------------------------------------------------------------
# Shared cell addressing
# ---------------------------------------------------------------------------

def _locate_alloc(table, geo: MapGeometry, cells, trash: int):
    """:func:`pool.locate`, allocating the missing patches first
    (mutable-get semantics, map.cpp:371-411).

    The JAX package inserts the sorted unique keys one after the other;
    keys already in the table change nothing there, so only the missing
    ones go through :func:`pool.table_insert`, in the same order. One host
    read (the count of missing keys).
    """
    keys = geo.m2p(cells).reshape(-1)
    uniq = torch.unique(keys)                       # sorted
    uniq = uniq[uniq >= 0]
    missing = uniq[pool_mod.table_lookup(table, uniq) < 0]
    if missing.numel():
        table, _ = pool_mod.table_insert(table, missing)
    slots, idx = pool_mod.locate(table, geo, cells, trash)
    return table, slots, idx


# ---------------------------------------------------------------------------
# Simple occupancy (simple_occupancy_map.cpp:36-130)
# ---------------------------------------------------------------------------

def simple_set(state: SimpleOccupancyState, geo, cells, value,
               mask=None) -> SimpleOccupancyState:
    """Set cells to -1 (free), 0 (unknown) or +1 (occupied); ``mask``
    (bool, cells' shape) sends the unmasked cells to the trash slot."""
    trash = state.cells.shape[0] - 1
    table, _, (safe, ly, lx) = _locate_alloc(state.table, geo, cells, trash)
    val = torch.as_tensor(value, dtype=torch.int8,
                          device=state.cells.device).expand(safe.shape)
    if mask is not None:
        safe = torch.where(mask, safe, trash)
    out = state.cells.clone()
    out[safe, ly, lx] = val
    return SimpleOccupancyState(table, out)


def _cells_are(state: SimpleOccupancyState, geo, cells, value: int,
               missing: bool):
    slots, idx = pool_mod.locate(state.table, geo, cells,
                                 state.cells.shape[0] - 1)
    return torch.where(slots >= 0, state.cells[idx] == value, missing)


def simple_is_free(state: SimpleOccupancyState, geo, cells):
    return _cells_are(state, geo, cells, -1, False)


def simple_is_occupied(state: SimpleOccupancyState, geo, cells):
    return _cells_are(state, geo, cells, 1, False)


def simple_is_unknown(state: SimpleOccupancyState, geo, cells):
    return _cells_are(state, geo, cells, 0, True)


# ---------------------------------------------------------------------------
# Frequency occupancy (frequency_occupancy_map.cpp)
# ---------------------------------------------------------------------------

def scatter_sum(shape, idx, values, dtype):
    """Dense ``shape`` array (``[P+1, L, L]`` or ``[P+1, L, L, L]``) of
    ``values`` summed at the index tuple ``idx`` (slot, then a local index
    an axis; duplicates accumulate): one ``index_add_`` on the flat cell
    index (atomics on the card; integer sums, and float sums of integers
    below 2**24, are exact in any order)."""
    flat = idx[0]
    for i, n in zip(idx[1:], shape[1:]):
        flat = flat * n + i
    out = torch.zeros(shape, dtype=dtype, device=values.device)
    out.view(-1).index_add_(0, flat.reshape(-1),
                            values.to(dtype).expand(idx[0].shape).reshape(-1))
    return out


def frequency_apply_counts(state: FrequencyOccupancyState, geo, cells,
                           occ_add, vis_add) -> FrequencyOccupancyState:
    """Scatter-add per-cell counts (end states equal sequential ``set*``
    calls). Counts add mod 2**16 like the JAX package's uint16 scatter:
    each added count is taken mod 2**16, the sums in int64."""
    trash = state.occupied.shape[0] - 1
    table, _, idx = _locate_alloc(state.table, geo, cells, trash)
    shape = state.occupied.shape

    def add(counts, more):
        more = more.to(torch.int64) & U16_MASK
        total = counts.to(torch.int64) + scatter_sum(shape, idx, more,
                                                      torch.int64)
        out = (total & U16_MASK).to(torch.int32)
        # keep the trash slot clean so pool-wide derivations stay valid
        out[trash] = 0
        return out

    return FrequencyOccupancyState(table, add(state.occupied, occ_add),
                                   add(state.visited, vis_add))


def _counts_at(state: FrequencyOccupancyState, geo, cells):
    slots, idx = pool_mod.locate(state.table, geo, cells,
                                 state.occupied.shape[0] - 1)
    return slots, state.occupied[idx], state.visited[idx]


def frequency_prob(state: FrequencyOccupancyState, geo, cells):
    """getProbability (frequency_occupancy_map.cpp:157-170)."""
    slots, occ, vis = _counts_at(state, geo, cells)
    occ, vis = occ.to(torch.float32), vis.to(torch.float32)
    thresh = f32(OCC_THRESH)
    prob = torch.where(vis > 0, occ / torch.clamp(vis, min=1.0), thresh)
    return torch.where(slots >= 0, prob, thresh)


def frequency_is_free(state, geo, cells):
    slots, occ, vis = _counts_at(state, geo, cells)
    return torch.where(slots >= 0, (vis > 0) & (4 * occ < vis), False)


def frequency_is_occupied(state, geo, cells):
    slots, occ, vis = _counts_at(state, geo, cells)
    return torch.where(slots >= 0, 4 * occ > vis, False)


def frequency_is_unknown(state, geo, cells):
    slots, _, vis = _counts_at(state, geo, cells)
    return torch.where(slots >= 0, vis == 0, True)


def frequency_prune(state: FrequencyOccupancyState) -> FrequencyOccupancyState:
    """Drop single-visit cells (frequency_occupancy_map.cpp:146-155)."""
    drop = (state.visited == 1) & (state.occupied <= 1)
    return state._replace(occupied=torch.where(drop, 0, state.occupied),
                          visited=torch.where(drop, 0, state.visited))


# ---------------------------------------------------------------------------
# Probabilistic occupancy (probabilistic_occupancy_map.cpp)
# ---------------------------------------------------------------------------

def probabilistic_apply(state: ProbabilisticOccupancyState, geo, cells,
                        hits, misses) -> ProbabilisticOccupancyState:
    """Apply per-cell hit/miss counts with per-visit clamping.

    Duplicate cells accumulate their counts first (float sums of integers
    below 2**24: exact in any order), then the per-visit saturating
    closed form applies pool-wide (:func:`probabilistic_saturate`)."""
    trash = state.logodds.shape[0] - 1
    table, _, idx = _locate_alloc(state.table, geo, cells, trash)
    shape = state.logodds.shape
    hcount = scatter_sum(shape, idx, hits, torch.float32)
    mcount = scatter_sum(shape, idx, misses, torch.float32)
    lo = probabilistic_saturate(state.logodds, hcount, mcount)
    written = scatter_sum(shape, idx, (hits > 0) | (misses > 0),
                           torch.int32)
    touched = state.touched | (written > 0)
    lo[trash] = 0.0
    touched[trash] = False
    return ProbabilisticOccupancyState(table, lo, touched)


def probabilistic_prob(state: ProbabilisticOccupancyState, geo, cells):
    """getProbability = 1 - 1/(1+exp(l))
    (probabilistic_occupancy_map.cpp:40)."""
    slots, idx = pool_mod.locate(state.table, geo, cells,
                                 state.logodds.shape[0] - 1)
    prob = 1.0 - 1.0 / (1.0 + torch.exp(state.logodds[idx]))
    return torch.where(slots >= 0, prob, 0.5)


def probabilistic_is_occupied(state, geo, cells):
    slots, idx = pool_mod.locate(state.table, geo, cells,
                                 state.logodds.shape[0] - 1)
    return torch.where(slots >= 0, state.logodds[idx] > 0.0, False)


def probabilistic_is_free(state, geo, cells):
    slots, idx = pool_mod.locate(state.table, geo, cells,
                                 state.logodds.shape[0] - 1)
    free = (state.logodds[idx] < 0.0) & state.touched[idx]
    return torch.where(slots >= 0, free, False)
