"""Rank functions of the port's parallel tests (tests/test_torch_group.py,
test_torch_distributed_pgo.py, test_torch_map_rebuild.py,
test_torch_graph_slam2d.py, test_torch_pf_sharding.py).

A spawned rank imports the module of its function, so this module imports
torch and the port only, never JAX (the test modules import JAX at their
top). Every function runs as ``fn(rank, world, *args)`` under
``parallel.group.run_ranks`` and returns host values.
"""

import time

import torch

from iris_lama_tpu_torch.parallel import group as G


def group_checks(r, w, seed):
    """Each helper of parallel/group.py on seeded tensors: returns what the
    rank computed beside the single-process answer."""
    world = torch.distributed.group.WORLD
    g = torch.Generator().manual_seed(seed)
    n = 3
    full = torch.randn((n * w, 2, 5), generator=g)
    mine = full[r * n:(r + 1) * n]
    out = {"sum": (G.all_sum(mine, world),
                   sum(full[k * n:(k + 1) * n] for k in range(w))),
           "gather": (G.all_gather_cat(mine, world), full),
           "gather_int": (G.all_gather_cat(mine.to(torch.int32), world),
                          full.to(torch.int32))}
    perm = torch.randperm(n * w, generator=g)
    ragged = torch.randint(0, n * w, (n * w,), generator=g)
    # every row moves (a rotation by one rank), none moves, a random
    # permutation, and draws with repeats (ragged splits)
    for name, idx in (("all_move", (torch.arange(n * w) + n) % (n * w)),
                      ("none_move", torch.arange(n * w)),
                      ("perm", perm), ("ragged", ragged)):
        got = mine.clone()
        moved = G.exchange_rows([got], idx, world)
        want = full[idx][r * n:(r + 1) * n]
        crossing = int(sum((idx[i] // n != i // n) for i in range(n * w)))
        out[name] = (got, want, moved, crossing * mine[:1].numel() * 4)
    # two arrays of other row shapes and dtypes in one exchange (one plan):
    # the bytes are both arrays' crossing rows
    a, b = mine.clone(), (mine[:, 0, :2] > 0).clone()
    moved = G.exchange_rows([a, b], perm, world)
    crossing = int(sum((perm[i] // n != i // n) for i in range(n * w)))
    out["two_arrays"] = ((a, b), (full[perm][r * n:(r + 1) * n],
                                  (full[perm][r * n:(r + 1) * n, 0, :2] > 0)),
                         moved, crossing * (10 * 4 + 2))
    mask = full[:, 0, :] > 0
    strip = mask[r * n:(r + 1) * n]
    above, below = G.halo_exchange(strip, 2, world)
    want_a = (mask[r * n - 2:r * n] if r > 0
              else torch.zeros((2, 5), dtype=torch.bool))
    want_b = (mask[(r + 1) * n:(r + 1) * n + 2] if r < w - 1
              else torch.zeros((2, 5), dtype=torch.bool))
    out["halo"] = ((above, below), (want_a, want_b))
    return out


def fail_on_rank(r, w, bad):
    if r == bad:
        raise ValueError(f"rank {r} fails on purpose")
    return r


def hang_on_rank(r, w, bad):
    if r == bad:
        time.sleep(3600)
    return r


def pgo(r, w, problems, gn, cg):
    """optimize_distributed on this rank's factors of each (nodes, graph
    numpy fields, active) of ``problems``: [(nodes, chi2_history)]."""
    from iris_lama_tpu_torch.nlls import factor_graph as fg
    from iris_lama_tpu_torch.parallel import distributed_pgo as dpgo
    mesh = torch.distributed.group.WORLD
    out = []
    for nodes, graph, active in problems:
        full = fg.SE2Graph(*(torch.as_tensor(a) for a in graph))
        got, info = dpgo.optimize_distributed(
            torch.as_tensor(nodes), dpgo.shard_graph(full, mesh),
            torch.as_tensor(active),
            dpgo.DistributedPGOOptions(gn_iterations=gn, cg_iterations=cg),
            mesh=mesh)
        out.append((got.numpy(), info["chi2_history"].numpy()))
    return out


def rebuild(r, w, opts, scans, bounds):
    """rebuild_dense(mesh=...) of ``scans`` on the Slam2D options
    ``opts`` (a dict)."""
    from iris_lama_tpu_torch.algos.slam2d import Slam2DOptions
    from iris_lama_tpu_torch.parallel import map_rebuild
    cfg = Slam2DOptions(**opts).mapping_config()
    org, h, w_ = bounds
    d = map_rebuild.rebuild_dense(cfg, *(torch.as_tensor(a) for a in scans),
                                  org, h, w_,
                                  mesh=torch.distributed.group.WORLD)
    return {k: getattr(d, k).numpy() for k in ("occ", "vis", "dist")}


def edt_strips(r, w, obst, cap, radius):
    """edt_strips on this rank's rows of ``obst`` (rows a multiple of the
    world size), the whole grid gathered; and whether a strip shorter than
    the radius raised ValueError."""
    from iris_lama_tpu_torch.parallel import map_rebuild
    o = torch.as_tensor(obst)
    mesh = torch.distributed.group.WORLD
    d = map_rebuild.edt_strips(o[G.rows(o.shape[0], mesh)], cap, radius,
                               mesh)
    try:
        map_rebuild.edt_strips(o[:radius - 1], cap, radius, mesh)
        short = False
    except ValueError:
        short = True
    return G.all_gather_cat(d, mesh).numpy(), short


def graph_rebuild(r, w, options, cloud, odom, state):
    """GraphSlam2D.generate_occupancy_map(mesh=...) from a driver state
    (utils.state.graph_to_numpy's layout; the driver takes a first scan
    before the state is loaded, as the graph tests' ``_carried`` does)."""
    from iris_lama_tpu_torch.algos import graph_slam2d
    from iris_lama_tpu_torch.utils import state as st
    gs = graph_slam2d.GraphSlam2D(options, device="cpu")
    gs.update(cloud, odom, 0.0)
    st.graph_from_numpy(gs, state)
    m = gs.generate_occupancy_map(mesh=torch.distributed.group.WORLD)
    return st.map_to_numpy(m)


def pf_steps(r, w, opts_kw, steps, scan):
    """The sharded PF update from each (particle set, u) of ``steps``
    (utils.state.pset_to_numpy's layout): on rank 0 the whole set after
    each update and its info; None on the other ranks."""
    from iris_lama_tpu_torch.algos import pf_slam2d as pf
    from iris_lama_tpu_torch.parallel import pf_sharding
    from iris_lama_tpu_torch.utils import state as st
    opts = pf.PFSlam2DOptions(**opts_kw)
    mesh = pf_sharding.particle_mesh()
    update = pf_sharding.make_sharded_update(opts, mesh)
    pts, msk, org = (torch.as_tensor(a) for a in scan)
    out = []
    for d, u in steps:
        ps = pf_sharding.shard_particles(
            st.pset_from_numpy(opts, d, "cpu"), mesh)
        ps, info = update(ps, torch.tensor(u, dtype=torch.float32), pts,
                          msk, org)
        full = pf_sharding.gather_particles(ps, mesh)
        out.append(None if full is None else (
            st.pset_to_numpy(full),
            {k: (v if isinstance(v, int) else v.item())
             for k, v in info.items()}))
    return out if r == 0 else None


def pf_motion(r, w, opts_kw, pose, eps, odelta):
    """make_sharded_motion on this rank's rows; the whole pose gathered."""
    from iris_lama_tpu_torch.algos import pf_slam2d as pf
    from iris_lama_tpu_torch.parallel import pf_sharding
    opts = pf.PFSlam2DOptions(**opts_kw)
    mesh = pf_sharding.particle_mesh()
    pose = torch.as_tensor(pose)
    mine = pose[G.rows(pose.shape[0], mesh)]
    got = pf_sharding.make_sharded_motion(opts, mesh)(
        mine, torch.as_tensor(eps), torch.as_tensor(odelta))
    return G.all_gather_cat(got, mesh).numpy()
