"""The collectives of the parallel paths, on a ``torch.distributed`` process
group, and the spawner of the ranks.

The JAX package runs its parallel paths single-controller: ``shard_map`` or
pinned shardings over a device mesh, with XLA inserting the ``psum``,
``ppermute`` and resample gathers. Here every rank is a process with its
share of the rows, and the few collectives the paths need are plain
functions on tensors:

* :func:`all_sum` — a sum all-reduce;
* :func:`all_gather_cat` — an all-gather, concatenated along the leading
  axis (every rank holds the same number of rows);
* :func:`exchange_rows` — the rows of arrays sharded over the ranks
  re-ordered in place by a global index that every rank holds: only the
  rows that change rank travel (one ``all_to_all_single`` with split
  sizes an array, one host plan for all of them);
* :func:`halo_exchange` — ``radius`` rows from each neighbouring rank
  (``batch_isend_irecv``), all-zero at the edge ranks;
* :func:`run_ranks` — spawns the ranks of one world and returns what each
  rank's function returned.

Transport. NCCL moves device tensors as they are. Gloo moves host memory
(it has no device path for send/recv and all-to-all), so under gloo each
helper copies a device tensor to the host for the collective and the
result back to the tensor's device: the compute stays on the device the
caller gave, only the bytes travel through the host. This is the caller's
choice of backend, not a fallback.

``group`` is a process group. ``None`` means one process and no group (the
JAX package's ``mesh=None``): each helper then returns its single-process
meaning and touches no ``torch.distributed`` state, so one code path
serves the sharded and the unsharded run.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def size(group=None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group=None) -> int:
    return 0 if group is None else dist.get_rank(group)


def rows(n: int, group=None) -> slice:
    """This rank's rows of an axis of ``n`` rows split evenly over the
    group's ranks (the JAX package's ``P(axis)`` placement)."""
    w = size(group)
    if n % w:
        raise ValueError(f"{n} rows do not split over {w} ranks")
    k = n // w
    r = rank(group)
    return slice(r * k, (r + 1) * k)


def _host_staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _wire(t, group):
    """The tensor a collective sees: a contiguous copy, on the host under
    gloo; bool travels as uint8."""
    t = t.to(torch.uint8) if t.dtype == torch.bool else t
    if _host_staged(group):
        return t.to("cpu", copy=True).contiguous()
    return t.clone(memory_format=torch.contiguous_format)


def _back(w, like):
    return w.to(device=like.device, dtype=like.dtype)


def all_sum(t, group=None):
    """The sum of ``t`` over the group's ranks (a new tensor; ``t`` itself
    without a group)."""
    if group is None:
        return t
    w = _wire(t, group)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return _back(w, t)


def all_gather_cat(t, group=None):
    """Every rank's ``t`` concatenated along the leading axis, in rank
    order; every rank passes the same shape (``t`` itself without a
    group)."""
    if group is None:
        return t
    w = _wire(t, group)
    parts = [torch.empty_like(w) for _ in range(size(group))]
    dist.all_gather(parts, w, group=group)
    return _back(torch.cat(parts), t)


def exchange_plan(idx, n_local: int, world: int):
    """Host plan of :func:`exchange_rows` for the global index ``idx``
    (numpy int [N]): for every pair (source rank, destination rank) the
    destination rows, in order, that take a row of the source. Returns
    ``plan[s][d]`` (int64 arrays of global destination rows)."""
    src = idx // n_local
    dst = np.arange(idx.shape[0]) // n_local
    return [[np.nonzero((src == s) & (dst == d))[0] for d in range(world)]
            for s in range(world)]


def exchange_rows(xs, idx, group=None) -> int:
    """Re-order the rows of arrays sharded over the ranks by a global
    index, IN PLACE: global row ``i`` of each array becomes its global row
    ``idx[i]``. Each array of ``xs`` is this rank's [n, ...] rows (rank r
    holds global rows r*n .. r*n+n-1); ``idx`` (int [N = world * n]) is the
    same on every rank. Without a group this is ``x.copy_(x[idx])`` for
    each array (no host read). Under a group ``idx`` is read to the host
    and planned once for all the arrays: rows whose source is on the rank
    are copied there, the others travel in one ``all_to_all_single`` an
    array, each once, with one array's temporary at a time; an identity
    ``idx`` moves nothing.

    Returns the bytes of the rows that changed rank, over the whole group
    and all the arrays (the same number on every rank; 0 without a
    group)."""
    if group is None:
        for x in xs:
            x.copy_(x[idx])
        return 0
    w, r = size(group), rank(group)
    n = xs[0].shape[0]
    ih = idx.detach().to("cpu", torch.int64).numpy()
    if ih.shape[0] != n * w:
        raise ValueError(f"index of {ih.shape[0]} rows for {w} ranks of {n}")
    if np.array_equal(ih, np.arange(ih.shape[0])):
        return 0
    plan = exchange_plan(ih, n, w)
    moved = sum(plan[s][d].shape[0] for s in range(w) for d in range(w)
                if s != d)
    base = r * n
    keep = plan[r][r]
    send_rows = [plan[r][d] if d != r else plan[r][d][:0] for d in range(w)]
    recv_rows = [plan[s][r] if s != r else plan[s][r][:0] for s in range(w)]
    dev = xs[0].device

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    keep_dst, keep_src = on_dev(keep - base), on_dev(ih[keep] - base)
    send_src = on_dev(np.concatenate([ih[a] - base for a in send_rows]))
    recv_dst = on_dev(np.concatenate(recv_rows) - base)
    send_n = [a.shape[0] for a in send_rows]
    recv_n = [a.shape[0] for a in recv_rows]
    total = 0
    for x in xs:
        out = torch.empty_like(x)
        if keep.shape[0]:
            out[keep_dst] = x[keep_src]
        if moved:
            send = _wire(x[send_src], group)
            recv = torch.empty((sum(recv_n), *x.shape[1:]),
                               dtype=send.dtype, device=send.device)
            dist.all_to_all_single(recv, send, recv_n, send_n, group=group)
            if recv_dst.shape[0]:
                out[recv_dst] = _back(recv, x)
        x.copy_(out)
        total += moved * x[:1].numel() * x.element_size()
    return total


def halo_exchange(strip, radius: int, group=None):
    """The ``radius`` rows above and below this rank's row strip: the
    bottom rows of the rank before and the top rows of the rank after
    (all zero at the first and the last rank, where the grid ends).
    Returns (above, below), each [radius, ...] like ``strip``; without a
    group the one strip is the whole grid, so both are zero."""
    w, r = size(group), rank(group)
    if strip.shape[0] < radius:
        raise ValueError(f"a strip of {strip.shape[0]} rows is shorter "
                         f"than the halo ({radius})")
    if group is None:
        zeros = torch.zeros_like(strip[:radius])
        return zeros, zeros.clone()
    top = _wire(strip[:radius], group)
    bot = _wire(strip[strip.shape[0] - radius:], group)
    above, below = torch.zeros_like(top), torch.zeros_like(bot)
    ops = []

    def peer(k):
        return dist.get_global_rank(group, k)

    if r > 0:
        ops += [dist.P2POp(dist.isend, top, peer(r - 1), group),
                dist.P2POp(dist.irecv, above, peer(r - 1), group)]
    if r < w - 1:
        ops += [dist.P2POp(dist.isend, bot, peer(r + 1), group),
                dist.P2POp(dist.irecv, below, peer(r + 1), group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _back(above, strip), _back(below, strip)


# ---------------------------------------------------------------------------
# Spawning the ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, r: int, world: int, backend: str, init: str, out: str,
               timeout: float, args: tuple) -> None:
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(r)
        dist.init_process_group(
            backend, init_method=init, world_size=world, rank=r,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(r, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out, f"result{r}.pt"))
    except BaseException:
        with open(os.path.join(out, f"error{r}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_ranks(fn, world: int, backend: str = "gloo",
              timeout: float = 120.0, args: tuple = ()) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one process group, and return what each returned (in rank order;
    it travels through ``torch.save``).

    ``fn`` is a module-level function: a spawned rank imports its module,
    so that module must not import what the rank lacks. The ranks meet
    through a ``file://`` store in a fresh temporary directory (no port,
    so concurrent worlds never collide); each runs one torch thread, and
    under ``nccl`` rank r takes ``cuda:r``. Raises RuntimeError, with the
    rank's traceback, as soon as a rank fails, and TimeoutError when the
    ranks have not all finished within ``timeout`` seconds; either way
    every rank still running is killed first."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = tempfile.mkdtemp(prefix="ranks-")
    try:
        init = "file://" + os.path.join(out, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, init, out, timeout,
                                   args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if not p.is_alive() and p.exitcode != 0]
                if failed:
                    raise RuntimeError(_failure(out, failed, procs))
                if time.monotonic() > deadline:
                    late = [r for r, p in enumerate(procs) if p.is_alive()]
                    raise TimeoutError(f"rank(s) {late} of {world} did not "
                                       f"finish within {timeout} s")
                time.sleep(0.02)
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                raise RuntimeError(_failure(out, failed, procs))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        return [torch.load(os.path.join(out, f"result{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _failure(out: str, failed: list, procs: list) -> str:
    msgs = []
    for r in failed:
        path = os.path.join(out, f"error{r}.txt")
        text = (open(path).read() if os.path.exists(path)
                else f"exit code {procs[r].exitcode}")
        msgs.append(f"--- rank {r} ---\n{text}")
    return "rank(s) failed:\n" + "\n".join(msgs)
