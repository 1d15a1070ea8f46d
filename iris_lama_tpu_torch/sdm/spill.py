"""Host spill tier: unbounded maps on a bounded device patch pool.

reference: the sparse-dense map's LRU compress-on-evict machinery —
``Map::get`` decompresses through an LRU cache and evicted patches live
LZ4/ZSTD-compressed in RAM (src/sdm/map.cpp:375-398 cached access,
:593-623 evict + compress; Options use_compression/cache_size,
include/lama/slam2d.h:115-120).

Device memory is the cache. The patch pool (capacity P) holds the working
set; patches the robot has moved away from are *spilled*: pulled to the
host in one copy, compressed (``utils/codec.py``) and their pool slots
freed. When the robot comes back, the driver *refills* the stored patches
the next update window could touch (decompress, one copy to the device,
insert-if-missing). The map update never knows: a spilled and refilled
patch is the patch that never left.

* device: :func:`extract_patches` (gather the blocks, remove the keys,
  reset the freed slots), :func:`inject_patches` (insert the missing keys,
  write their blocks; a key already on the device keeps its newer block),
  :func:`snapshot_keys` (the active keys, one read); the ``_batch`` forms
  take a leading particle axis and loop over the particles (spills are
  rare events).
* host (:class:`HostSpillStore`, :class:`PFSpillStore`): the compressed
  dicts, victim selection by distance from the synced pose, the
  hit/spill/refill counters (the reference's cacheHit/cacheMiss,
  sdm/map.h:264-268). Its host reads go through ``utils.trace.host_read``
  (site ``spill``); spills and refills are spanned ``lama.spill`` and
  ``lama.refill``.

Blobs hold the JAX package's bytes: uint16 counts (or float32 log-odds),
uint16 visits, float32 meters, compressed by the same codec, so either
package reads the other's store. The port's counts are int32 clipped at
65535 (sdm/mapping.py), so the uint16 conversion is exact both ways.

Correctness: every patch an update can read or write lies in its window;
the driver refills every stored key within the window of the predicted
pose plus ``margin`` patches before the update, and victims lie strictly
outside ``keep_radius``, which exceeds the window's reach.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..utils.codec import BufferCompressor
from ..utils.trace import host_read, span
from . import mapping as mapping_mod
from . import pool as pool_mod
from .geometry import PKEY_BITS


def _keys_np(keys) -> np.ndarray:
    if isinstance(keys, torch.Tensor):
        keys = host_read(keys.detach(), "spill", numpy=True)
    return np.asarray(keys, np.int32).reshape(-1)


def _view(maps: mapping_mod.SlamMapState, i: int) -> mapping_mod.SlamMapState:
    """Particle ``i``'s pool as views (in-place writes land in ``maps``)."""
    return mapping_mod.SlamMapState(
        pool_mod.PatchTable(*(t[i] for t in maps.table)), maps.occupied[i],
        maps.visited[i], maps.dist[i])


def _store_table(maps: mapping_mod.SlamMapState, i: int, table) -> None:
    for dst, src in zip(maps.table, table):
        dst[i] = src


def extract_patches(state: mapping_mod.SlamMapState, cfg, keys):
    """Pull ``keys`` (int32 [M], -1 entries skipped) out of the pool.

    Returns (state, occ [M, L, L], vis [M, L, L], dist [M, L, L], present
    bool [M]). The freed slots are reset in place (counts 0, distances
    ``max_dist``); an absent key comes back with the trash slot's blocks
    and ``present=False``, and the trash slot is left alone. The keys must
    be unique among their non-negative entries (victim lists are): they
    are removed in one vectorised pass (``pool.table_remove_vec``, the
    JAX package's sequential removal's table).
    """
    keys_np = _keys_np(keys)
    valid = keys_np[keys_np >= 0]
    if len(np.unique(valid)) != len(valid):
        raise ValueError("extract_patches: duplicate keys")
    dev = state.dist.device
    k = torch.as_tensor(keys_np, device=dev)
    slots = pool_mod.table_lookup(state.table, k)
    present = slots >= 0
    trash = state.dist.shape[0] - 1
    safe = torch.where(present, slots, trash).long()
    occ, vis, dist = (state.occupied[safe], state.visited[safe],
                      state.dist[safe])
    table, freed = pool_mod.table_remove_vec(state.table, k)
    # the trash slot already holds the reset values: writes there change
    # nothing, so no mask (and no host read) is needed
    at = torch.where(freed >= 0, freed, trash).long()
    state.occupied[at] = 0
    state.visited[at] = 0
    state.dist[at] = cfg.distance.max_dist
    return state._replace(table=table), occ, vis, dist, present


def inject_patches(state: mapping_mod.SlamMapState, cfg, keys, occ, vis,
                   dist):
    """Insert ``keys`` (int32 [M], -1 entries skipped) with their cell
    blocks ``[M, L, L]``, one after the other (``pool.table_insert``).

    A key already on the device is left as it is (its block is newer than
    the stored one). Returns (state, droppable bool [M]): the keys whose
    content now lives on the device (freshly injected or already present);
    a key that found the pool full is not droppable.
    """
    dev = state.dist.device
    k = torch.as_tensor(keys, device=dev).to(torch.int32).reshape(-1)
    pre = pool_mod.table_lookup(state.table, k)
    cand = torch.where(pre == pool_mod.EMPTY, k, -1)
    table, _ = pool_mod.table_insert(state.table, cand)
    post = pool_mod.table_lookup(table, k)
    injected = (pre == pool_mod.EMPTY) & (post >= 0)
    droppable = injected | (pre >= 0)
    # skipped entries write the trash slot's own values into it
    trash = state.dist.shape[0] - 1
    at = torch.where(injected, post, trash).long()
    sel = injected[:, None, None]
    for arr, blk in ((state.occupied, occ), (state.visited, vis),
                     (state.dist, dist)):
        arr[at] = torch.where(sel, blk.to(arr.dtype), arr[trash])
    return state._replace(table=table), droppable


def extract_patches_batch(maps: mapping_mod.SlamMapState, cfg, keys):
    """:func:`extract_patches` over a leading particle axis with one
    shared key list (keys a particle lacks come back ``present=False``).
    Returns (maps, occ [N, M, L, L], vis, dist, present [N, M])."""
    keys_np = _keys_np(keys)
    outs = []
    for i in range(maps.dist.shape[0]):
        st, *blocks = extract_patches(_view(maps, i), cfg, keys_np)
        _store_table(maps, i, st.table)
        outs.append(blocks)
    return (maps, *(torch.stack(parts) for parts in zip(*outs)))


def inject_patches_batch(maps: mapping_mod.SlamMapState, cfg, keys, occ, vis,
                         dist):
    """:func:`inject_patches` over a leading particle axis: key lists
    ``[N, M]`` (-1 where a particle has nothing to inject) and blocks
    ``[N, M, L, L]``. Returns (maps, droppable [N, M])."""
    keys = torch.as_tensor(keys, device=maps.dist.device)
    drops = []
    for i in range(maps.dist.shape[0]):
        st, drop = inject_patches(_view(maps, i), cfg, keys[i], occ[i],
                                  vis[i], dist[i])
        _store_table(maps, i, st.table)
        drops.append(drop)
    return maps, torch.stack(drops)


def snapshot_keys(table: pool_mod.PatchTable):
    """int32 [P]: the active patch key of every slot, -1 where free."""
    keys, mask = pool_mod.active_keys(table)
    return torch.where(mask, keys, -1)


def snapshot_keys_batch(tables: pool_mod.PatchTable):
    """int32 [N, P]: :func:`snapshot_keys` of every particle's table."""
    n = tables.keys.shape[0]
    return torch.stack([snapshot_keys(pool_mod.PatchTable(
        *(t[i] for t in tables))) for i in range(n)])


def _blocks_to_host(occ, vis, dist, present):
    """One device-to-host copy of extracted blocks ``[..., L, L]`` and
    their ``present`` flags: (occ, vis, dist, present) as numpy."""
    float_occ = occ.dtype == torch.float32
    parts = [occ.view(torch.int32) if float_occ else occ.to(torch.int32),
             vis.to(torch.int32), dist.view(torch.int32),
             present.to(torch.int32)]
    h = host_read(torch.cat([p.reshape(-1) for p in parts]), "spill",
                  numpy=True)
    n = occ.numel()
    shape = tuple(occ.shape)
    occ_h = h[:n].reshape(shape)
    return ((occ_h.view(np.float32) if float_occ else occ_h),
            h[n:2 * n].reshape(shape),
            h[2 * n:3 * n].view(np.float32).reshape(shape),
            h[3 * n:].astype(bool).reshape(present.shape))


class HostSpillStore:
    """Compressed host store + spill/refill policy for one SLAM map."""

    def __init__(self, cfg, geo, codec: str = "lz4",
                 high_water: float = 0.85, low_water: float = 0.60,
                 margin_patches: int = 2):
        self.cfg = cfg
        self.geo = geo
        self.bc = BufferCompressor(codec)
        self.store: Dict[int, bytes] = {}
        self.high = int(high_water * cfg.capacity)
        self.low = int(low_water * cfg.capacity)
        self.margin = margin_patches
        self.cache_hit = 0    # refilled keys found in the store (cacheHit)
        # cacheMiss: a window key neither on the device nor stored; telling
        # needs a device lookup the steady state avoids, so it stays 0, as
        # in the JAX package
        self.cache_miss = 0
        self.spills = 0
        self.refills = 0
        # refill-window side in patches (PFSpillStore widens it to the
        # resident window)
        self._wp_refill = cfg.window_patches + 2 * margin_patches
        length = geo.patch_length
        self._occ_np = np.dtype(np.uint16 if cfg.occ_model == "frequency"
                                else np.float32)
        self._occ_nbytes = length * length * self._occ_np.itemsize
        self._vis_nbytes = length * length * 2
        self._dist_nbytes = length * length * 4

    # -- codec ---------------------------------------------------------------
    def _pack(self, occ_b, vis_b, dist_b) -> bytes:
        return self.bc.compress(occ_b + vis_b + dist_b)

    def _pack_blocks(self, occ, vis, dist) -> bytes:
        """A blob from one patch's numpy blocks in the port's dtypes."""
        return self._pack(occ.astype(self._occ_np).tobytes(),
                          vis.astype(np.uint16).tobytes(),
                          dist.astype(np.float32).tobytes())

    def _unpack(self, blob: bytes):
        raw = self.bc.decompress(
            blob, self._occ_nbytes + self._vis_nbytes + self._dist_nbytes)
        o = self._occ_nbytes
        v = o + self._vis_nbytes
        length = self.geo.patch_length
        occ = np.frombuffer(raw[:o], self._occ_np).reshape(length, length)
        vis = np.frombuffer(raw[o:v], np.uint16).reshape(length, length)
        dist = np.frombuffer(raw[v:], np.float32).reshape(length, length)
        return occ, vis, dist

    def _upload(self, keys, blobs, device):
        """One host-to-device copy of ``keys`` and their unpacked
        ``blobs``: (keys int32 [M], occ, vis, dist [M, L, L]) in the port's
        dtypes."""
        m, length = len(keys), self.geo.patch_length
        buf = np.zeros(m * 3 * length * length + m, np.int32)
        blocks = buf[:-m].reshape(m, 3, length, length) if m else buf
        for i, blob in enumerate(blobs):
            occ, vis, dist = self._unpack(blob)
            blocks[i, 0] = (occ.view(np.int32) if occ.dtype == np.float32
                            else occ)
            blocks[i, 1] = vis
            blocks[i, 2] = dist.view(np.int32)
        if m:
            buf[-m:] = keys
        dev = torch.from_numpy(buf).to(device)
        n = m * 3 * length * length
        blk = dev[:n].reshape(m, 3, length, length)
        occ = blk[:, 0]
        if self._occ_np == np.float32:
            occ = occ.view(torch.float32)
        return dev[n:], occ, blk[:, 1], blk[:, 2].view(torch.float32)

    # -- key geometry (host mirror of sdm/geometry.py's packing) -------------
    def _key_centers(self, keys: np.ndarray) -> np.ndarray:
        """World xy centres of patch keys [M] -> [M, 2]."""
        px = (keys >> PKEY_BITS).astype(np.int64)
        py = (keys & ((1 << PKEY_BITS) - 1)).astype(np.int64)
        l2 = self.geo.log2dim
        half = self.geo.patch_length // 2
        cells = np.stack([(px << l2) + half, (py << l2) + half], -1)
        return self.geo.np_m2w(cells)

    def window_keys_np(self, pose_xy: np.ndarray) -> np.ndarray:
        """Patch keys of the update window at ``pose_xy`` plus the margin
        (host mirror of sdm/window.py's window_org/window_patch_keys)."""
        cell = self.geo.np_w2m(np.asarray(pose_xy, np.float64))
        l2 = self.geo.log2dim
        wp = self._wp_refill
        org = (cell >> l2) - wp // 2
        px = (org[0] + np.arange(wp)).astype(np.int64)
        py = (org[1] + np.arange(wp)).astype(np.int64)
        return ((px[:, None] << PKEY_BITS) | py[None, :]).astype(
            np.int32).reshape(-1)

    # -- policy --------------------------------------------------------------
    def keep_radius_m(self) -> float:
        """Patches whose centre lies within this range of the pose are
        never spilled: the refill window's half extent plus one patch of
        snap and pose slack."""
        half_cells = (self._wp_refill // 2 + 1) * self.geo.patch_length
        return half_cells * self.geo.resolution

    def select_victims(self, active_keys: np.ndarray,
                       pose_xy: np.ndarray) -> np.ndarray:
        """Farthest-first victims to bring the pool down to low water."""
        keys = active_keys[active_keys >= 0]
        n_spill = len(keys) - self.low
        if n_spill <= 0:
            return np.zeros(0, np.int32)
        centers = self._key_centers(keys)
        d = np.linalg.norm(centers - np.asarray(pose_xy)[None, :], axis=1)
        keep = self.keep_radius_m()
        order = np.argsort(-d)
        victims = [k for k in order[:n_spill] if d[k] > keep]
        return keys[victims].astype(np.int32)

    # -- events --------------------------------------------------------------
    def spill(self, state, pose_xy: np.ndarray):
        """Spill far patches to the host store; returns the new state."""
        with span("lama.spill"):
            active = host_read(snapshot_keys(state.table), "spill",
                               numpy=True)
            victims = self.select_victims(active, pose_xy)
            if len(victims) == 0:
                return state
            state, *blocks = extract_patches(state, self.cfg, victims)
            occ, vis, dist, present = _blocks_to_host(*blocks)
            for i, k in enumerate(victims):
                if present[i]:
                    self.store[int(k)] = self._pack_blocks(occ[i], vis[i],
                                                           dist[i])
            self.spills += 1
            return state

    def refill(self, state, pose_xy: np.ndarray):
        """Re-inject the stored patches the next window could touch."""
        with span("lama.refill"):
            need = self.window_keys_np(pose_xy)
            hits = [int(k) for k in need if int(k) in self.store]
            if not hits:
                return state
            self.cache_hit += len(hits)
            keys, occ, vis, dist = self._upload(
                hits, [self.store[k] for k in hits], state.dist.device)
            state, droppable = inject_patches(state, self.cfg, keys, occ, vis,
                                              dist)
            # drop the blobs whose content now lives on the device; keep any
            # that found the pool full, for a later attempt
            drop = host_read(droppable, "spill", numpy=True)
            for i, k in enumerate(hits):
                if drop[i]:
                    del self.store[k]
            self.refills += 1
            return state

    def memory_usage(self) -> int:
        return sum(len(b) for b in self.store.values())

    def merged_map(self, state):
        """The full map (device + stored patches) in a fresh pool of the
        next power-of-two capacity: (state, cfg).

        For map IO and export: the ``.smd`` writers walk the device pool
        only (the reference's Map::write decompresses through its cache,
        src/sdm/map.cpp:497-516). The device patches come first, then the
        stored keys in ascending order, inserted one by one as the JAX
        package does.
        """
        if not self.store:
            return state, self.cfg
        dev = state.dist.device
        dev_keys = host_read(snapshot_keys(state.table), "spill",
                             numpy=True)
        dev_keys = dev_keys[dev_keys >= 0]
        store_keys = np.asarray(sorted(self.store), np.int32)
        total = len(dev_keys) + len(store_keys)
        cap = 64
        while cap < total + 1:
            cap <<= 1
        big_cfg = dataclasses.replace(self.cfg, capacity=cap)
        big = mapping_mod.slam_map_init(big_cfg, dev)
        slots = pool_mod.table_lookup(
            state.table, torch.as_tensor(dev_keys, device=dev)).long()
        s_keys, s_occ, s_vis, s_dist = self._upload(
            store_keys, [self.store[int(k)] for k in store_keys], dev)
        keys = torch.cat([torch.as_tensor(dev_keys, device=dev), s_keys])
        table, islots = pool_mod.table_insert(big.table, keys)
        at = islots.long()
        big.occupied[at] = torch.cat([state.occupied[slots],
                                      s_occ.to(big.occupied.dtype)])
        big.visited[at] = torch.cat([state.visited[slots], s_vis])
        big.dist[at] = torch.cat([state.dist[slots], s_dist])
        return big._replace(table=table), big_cfg


class PFSpillStore(HostSpillStore):
    """Per-particle compressed host stores for PFSlam2D.

    reference: use_compression wires the compressor into every particle's
    occupancy and distance maps (src/pf_slam2d.cpp:201-204), and the
    copy-on-write map clones share compressed patches between particles
    until they diverge. Here: one dict per particle; a resample shares
    ancestral blobs through shallow-copied dicts. The driver keeps the
    composed resample permutation on the device (``ParticleSet.
    spill_lineage``) and calls :meth:`permute` with it right before it
    settles the pools, so that the stores follow the pools.

    The refill window covers the resident window (re-orgs regather window
    patches from the pool, so every stored patch a re-org could touch must
    be back first); the keep radius grows with it.
    """

    def __init__(self, cfg, geo, n_particles: int, codec: str = "lz4",
                 high_water: float = 0.8, low_water: float = 0.55,
                 margin_patches: int = 3):
        super().__init__(cfg, geo, codec, high_water, low_water,
                         margin_patches)
        self.stores = [dict() for _ in range(n_particles)]
        self._wp_refill = cfg.resident_window_patches + 2 * margin_patches

    # -- store bookkeeping ----------------------------------------------------
    def any_stored(self) -> bool:
        return any(self.stores)

    def stored_floor(self) -> int:
        """The fewest stored keys of any particle: a lower bound on the
        potential keys that no particle's pool holds."""
        return min((len(st) for st in self.stores), default=0)

    def permute(self, perm: np.ndarray) -> None:
        """stores[i] <- copy(stores[perm[i]]): the resample lineage the pool
        settle is about to realise. Shallow copies share blobs."""
        old = self.stores
        self.stores = [dict(old[int(j)]) for j in perm]

    def need_refill(self, pose_xy: np.ndarray) -> bool:
        need = set(int(k) for k in self.window_keys_np(pose_xy))
        return any(need.intersection(st) for st in self.stores)

    # -- events --------------------------------------------------------------
    def spill_batch(self, maps, pose_xy: np.ndarray):
        """Spill far patches of every particle (pools settled). Returns
        (maps, spilled_any)."""
        with span("lama.spill"):
            active = host_read(snapshot_keys_batch(maps.table), "spill",
                               numpy=True)
            counts = (active >= 0).sum(1)
            if int(counts.max()) - self.low <= 0:
                return maps, False
            union = np.unique(active[active >= 0]).astype(np.int32)
            centers = self._key_centers(union)
            d = np.linalg.norm(centers - np.asarray(pose_xy)[None, :], axis=1)
            far = union[d > self.keep_radius_m()]
            if len(far) == 0:
                return maps, False
            # farthest first
            far = far[np.argsort(-d[d > self.keep_radius_m()])]
            # the smallest farthest-first prefix that brings every particle
            # to low water
            member = np.stack([np.isin(far, row[row >= 0]) for row in active])
            after = counts[:, None] - member.cumsum(axis=1)
            ok = (after <= self.low).all(axis=0)
            n_take = int(np.argmax(ok)) + 1 if ok.any() else len(far)
            victims = np.sort(far[:n_take])
            maps, *blocks = extract_patches_batch(maps, self.cfg, victims)
            occ, vis, dist, present = _blocks_to_host(*blocks)
            for i, st in enumerate(self.stores):
                for m, k in enumerate(victims):
                    if present[i, m]:
                        st[int(k)] = self._pack_blocks(occ[i, m], vis[i, m],
                                                       dist[i, m])
            self.spills += 1
            return maps, True

    def refill_batch(self, maps, pose_xy: np.ndarray):
        """Re-inject every stored patch the resident window could touch,
        particle by particle (pools settled): one copy to the device of
        every particle's blocks, each particle's own keys only."""
        with span("lama.refill"):
            need = set(int(k) for k in self.window_keys_np(pose_xy))
            hits_per = [sorted(need.intersection(st)) for st in self.stores]
            if not any(hits_per):
                return maps
            self.cache_hit += sum(len(h) for h in hits_per)
            flat = [k for h in hits_per for k in h]
            blobs = [st[k] for st, h in zip(self.stores, hits_per) for k in h]
            keys, occ, vis, dist = self._upload(flat, blobs, maps.dist.device)
            drops, off = [], 0
            for i, h in enumerate(hits_per):
                if not h:
                    continue
                sl = slice(off, off + len(h))
                st, drop = inject_patches(_view(maps, i), self.cfg, keys[sl],
                                          occ[sl], vis[sl], dist[sl])
                _store_table(maps, i, st.table)
                drops.append(drop)
                off += len(h)
            drop = host_read(torch.cat(drops), "spill", numpy=True)
            off = 0
            for st, h in zip(self.stores, hits_per):
                for j, k in enumerate(h):
                    if drop[off + j]:
                        del st[k]
                off += len(h)
            self.refills += 1
            return maps

    def memory_usage(self) -> int:
        """Compressed bytes, a blob shared by particles counted once."""
        seen = set()
        total = 0
        for st in self.stores:
            for b in st.values():
                if id(b) not in seen:
                    seen.add(id(b))
                    total += len(b)
        return total

    def merged_map_particle(self, state_one, store_idx: int):
        """One particle's full map (device + its stored patches): see
        :meth:`HostSpillStore.merged_map`."""
        saved = self.store
        try:
            self.store = self.stores[store_idx]
            return self.merged_map(state_one)
        finally:
            self.store = saved
