"""Particle sharding for PFSlam2D over a process group.

reference parallelism: a ThreadPool fans one task per particle across CPU
threads with barrier waits (src/pf_slam2d.cpp:254-266, 292-302). The JAX
package shards the particle axis of every ParticleSet array over a device
mesh and lets GSPMD place the collectives. Here every rank is a process
that holds its share of the particles (rank r the rows r*n .. r*n+n-1 of
every particle-axis tensor; the resident window origin is replicated) and
the communication is explicit (``parallel/group.py``):

* motion, scan match (kernel B6 over the rank's particles) and the map
  update (B1's pair and B3 over the rank's particles, or on the pool path
  ``update_maps`` a particle) need none;
* the update itself is the unsharded one, ``pf.update_step`` or
  ``pf.pool_update_step`` called with ``mesh``: the collectives below are
  the group helpers, which are identities without a group;
* the weights: the N states, likelihoods, weights and match iterations
  are all-gathered (a few KB), and every rank normalises, computes Neff
  and the systematic resample indices on all N, identically: the indices
  are bit-equal to the unsharded filter's (partial sums would change the
  summation order, and with it the resample decisions);
* the draws are replicated: every rank draws the full [N, 3] motion noise
  and the resample ``u`` from the same generator state and takes its rows;
* the copies of whole particle state by index — the resample's gather of
  the resident grids (of the pools on the pool path) and the re-org's
  settle of the pools by ``lineage`` — are row exchanges: only the rows
  that change rank travel, and each update counts the bytes they moved.

The update re-orgs inside the step when any particle (of any rank) left
the resident safe zone, as the JAX package's ``pf_update_step`` does by
default: it settles the lineage through the row exchange, re-centres on
the mean particle cell of the gathered poses (the same ``_mean_anchor``
call on the same N poses as the unsharded filter) and flushes and
regathers the rank's own particles. On one process group of any size the
result is the unsharded update's, bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..algos import pf_slam2d as pf
from ..sdm import mapping
from ..sdm.pool import PatchTable
from . import group as group_mod


def particle_mesh(group=None):
    """The process group the particles are split over (the JAX package's
    device mesh): ``group``, or the default group."""
    return group if group is not None else dist.group.WORLD


def _particle_fields(pset: pf.ParticleSet):
    """(name, tensor) of every particle-axis field that is set."""
    return [(k, getattr(pset, k)) for k in pset._fields
            if k not in ("maps", "res_org") and getattr(pset, k) is not None]


def _map_rows(maps: mapping.SlamMapState, fn) -> mapping.SlamMapState:
    return mapping.SlamMapState(PatchTable(*(fn(t) for t in maps.table)),
                                fn(maps.occupied), fn(maps.visited),
                                fn(maps.dist))


def shard_particles(pset: pf.ParticleSet, mesh) -> pf.ParticleSet:
    """This rank's rows of every particle-axis tensor (copies, so the whole
    set can be freed); ``res_org`` replicated. ``lineage`` keeps global
    particle indices."""
    sl = group_mod.rows(pset.pose.shape[0], mesh)
    out = {k: t[sl].clone() for k, t in _particle_fields(pset)}
    return pset._replace(
        maps=_map_rows(pset.maps, lambda t: t[sl].clone()),
        res_org=None if pset.res_org is None else pset.res_org.clone(),
        **out)


def gather_particles(pset: pf.ParticleSet, mesh, dst: int = 0):
    """The whole particle set on rank ``dst`` (None on the other ranks),
    for comparisons: every particle-axis tensor gathered in rank order."""
    w, r = group_mod.size(mesh), group_mod.rank(mesh)
    host = dist.get_backend(mesh) == "gloo"
    root = (dst if mesh is None or mesh is dist.group.WORLD
            else dist.get_global_rank(mesh, dst))

    def gather(t):
        src = t.cpu() if host else t.contiguous()
        src = src.to(torch.uint8) if t.dtype == torch.bool else src
        parts = [torch.empty_like(src) for _ in range(w)] if r == dst \
            else None
        dist.gather(src, parts, dst=root, group=mesh)
        return (torch.cat(parts).to(t.device, t.dtype) if r == dst
                else None)

    fields = {k: gather(t) for k, t in _particle_fields(pset)}
    maps = _map_rows(pset.maps, gather)
    if r != dst:
        return None
    return pset._replace(maps=maps, **fields)


def make_sharded_motion(opts: pf.PFSlam2DOptions, mesh):
    """Motion for this rank's particles: ``motion(pose, eps, odelta)``
    with this rank's poses [n, 4] and the full draw ``eps`` [N, 3] (the
    same on every rank)."""
    def motion(pose, eps, odelta):
        sl = group_mod.rows(eps.shape[0], mesh)
        return pf.draw_from_motion(opts, eps[sl], odelta, pose)
    return motion


def _settle(pset: pf.ParticleSet, mesh):
    """:func:`pf.settle` on a sharded set: each rank's pools become those
    of its particles' lineage through the row exchange. Returns (pset,
    bytes moved)."""
    lineage = group_mod.all_gather_cat(pset.lineage, mesh).long()
    moved = group_mod.exchange_rows(pf.pool_arrays(pset.maps), lineage, mesh)
    sl = group_mod.rows(lineage.shape[0], mesh)
    return pset._replace(lineage=torch.arange(
        sl.start, sl.stop, dtype=torch.int32,
        device=pset.pose.device)), moved


def make_sharded_update(opts: pf.PFSlam2DOptions, mesh):
    """The PF update on this rank's particles: ``update(pset, u, points,
    mask, origin)`` -> (pset, info), with ``u`` the resample draw (the same
    on every rank) and the scan replicated. The pool path
    (``resident_window=False``) is ``pf.pool_update_step`` on the group;
    the resident path re-orgs first when any particle left the safe zone,
    as the JAX package's ``pf_update_step`` does, then runs
    ``pf.update_step`` on the group. ``info`` is theirs (over all N
    particles, the same on every rank), on the resident path with
    ``reorged``, and ``exchange_bytes`` counts the bytes every row
    exchange of the update (the re-org's settle included) moved between
    ranks (a host int)."""
    def update(pset: pf.ParticleSet, u, points, mask, origin):
        if pset.res_org is None:
            return pf.pool_update_step(opts, pset, u, points, mask, origin,
                                       mesh=mesh)
        cfg = opts.mapping_config()
        full_pose = group_mod.all_gather_cat(pset.pose, mesh)
        reorged = not bool(torch.all(mapping.resident_safe(
            cfg, pset.res_org, cfg.geometry.w2m(full_pose[:, :2]))))
        settled = 0
        if reorged:
            pset, settled = _settle(pset, mesh)
            pset = pf.recentre(opts, pset, mapping.resident_org(
                cfg, pf._mean_anchor(cfg, full_pose)))
        pset, info = pf.update_step(opts, pset, u, points, mask, origin,
                                    mesh=mesh)
        info.update(reorged=torch.tensor(reorged),
                    exchange_bytes=info["exchange_bytes"] + settled)
        return pset, info
    return update
