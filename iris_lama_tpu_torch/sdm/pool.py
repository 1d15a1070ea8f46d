"""Patch pool: an open-addressing table mapping patch keys to pool slots.

The replacement for the reference's ``unordered_map<uint64_t,
COWPtr<Container>>`` (include/lama/sdm/map.h:109): a fixed-capacity
``PatchTable`` of int32 ``keys``/``slots`` probed with bounded linear
probing, plus cell arrays ``[P + 1, L, L]`` owned by the map. Slot ``P``
is the trash slot: reads from missing patches are redirected there (and
masked); it is never written.

Every function is a plain tensor function; nothing reads back to the host,
so the table can live on the GPU between re-orgs. The arrays come out
bit-equal to the JAX package's for the same calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EMPTY = -1
TOMBSTONE = -2

# All entries are reachable within this probe window; insertion flags
# overflow instead of exceeding it, so a fixed-size probe is exact.
PROBE_WINDOW = 8

_INT32_MAX = 2 ** 31 - 1


class PatchTable(NamedTuple):
    """Open-addressing hash table + slot free-list (all int32 tensors)."""

    keys: torch.Tensor        # [H]; EMPTY / TOMBSTONE / patch key
    slots: torch.Tensor       # [H]; pool slot for the key
    free_slots: torch.Tensor  # [P]; stack of free slots
    n_free: torch.Tensor      # []; number of entries in free_slots
    overflow: torch.Tensor    # []; sticky count of failed inserts

    @property
    def capacity(self) -> int:
        return self.free_slots.shape[-1]

    @property
    def table_size(self) -> int:
        return self.keys.shape[-1]

    def num_patches(self):
        """Allocated patch count (map.h:210 ``numOfPatches``)."""
        return self.capacity - self.n_free


def table_init(capacity: int, table_factor: int = 4,
               device=None) -> PatchTable:
    """An empty table for ``capacity`` patches, with ``table_factor *
    capacity`` hash entries rounded up to a power of two."""
    h = 1
    while h < table_factor * capacity:
        h <<= 1
    i32 = dict(dtype=torch.int32, device=device)
    return PatchTable(
        keys=torch.full((h,), EMPTY, **i32),
        slots=torch.full((h,), EMPTY, **i32),
        # stack of free slots; pop order 0, 1, 2, ... for determinism
        free_slots=torch.arange(capacity - 1, -1, -1, **i32),
        n_free=torch.tensor(capacity, **i32),
        overflow=torch.tensor(0, **i32),
    )


def _mul32(h, c: int):
    """(h * c) mod 2**32 for 0 <= h < 2**32, in int64 without overflow."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _hash(keys, table_size: int):
    """murmur3 finalizer into [0, table_size) (a power of two), computed
    in int64 on the uint32 bit pattern of the keys."""
    h = keys.to(torch.int64) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h & (table_size - 1)


def table_lookup(table: PatchTable, keys):
    """keys int32[...] -> slots int32[...] (-1 = missing).

    The bounded linear probe: the first match within PROBE_WINDOW entries
    that comes before any EMPTY entry (tombstones do not stop the probe).
    """
    hsize = table.table_size
    shape = keys.shape
    flat = keys.reshape(-1)
    base = _hash(flat, hsize)                                  # int64
    offs = torch.arange(PROBE_WINDOW, device=flat.device)
    probed = table.keys[(base[:, None] + offs) % hsize]        # [N, W]
    big = torch.full_like(probed, PROBE_WINDOW, dtype=torch.int64)
    first_match = torch.where(probed == flat[:, None], offs, big).amin(-1)
    first_empty = torch.where(probed == EMPTY, offs, big).amin(-1)
    found = first_match < first_empty
    pos = (base + torch.clamp(first_match, max=PROBE_WINDOW - 1)) % hsize
    return torch.where(found, table.slots[pos], EMPTY).reshape(shape)


def locate(table: PatchTable, geo, cells, trash: int):
    """Where map cells int32 [..., 2] ([x, y]) live in the pool arrays:
    (slots int32 [...], -1 = missing; index tuple (slot, local y, local x)
    into a ``[P+1, L, L]`` array), a missing patch's cells indexing the
    ``trash`` slot."""
    slots = table_lookup(table, geo.m2p(cells))
    local = geo.m2local(cells).long()
    safe = torch.where(slots >= 0, slots, trash).long()
    return slots, (safe, local[..., 1], local[..., 0])


def table_insert_unique(table: PatchTable, keys):
    """Batch insert of keys that are UNIQUE among their non-negative
    entries (negative entries are skipped).

    Returns (table, slots int32[K]): existing or newly allocated slots,
    -1 where the pool is full or the probe window overflows (the sticky
    ``overflow`` counter counts those).

    PROBE_WINDOW claim rounds: at round j every pending key tries entry
    ``hash(k) + j``; contenders for one entry are resolved by a scatter-min
    (smallest key wins, losers go on to the next round). Slot ids follow
    the prefix-sum rank off the free stack; claims beyond the free pool
    are rolled back to TOMBSTONE. With no key pending this returns the
    lookup unchanged, so no branch (and no host read) is needed.
    """
    keys = keys.to(torch.int32).reshape(-1)
    dev = keys.device
    pre = table_lookup(table, keys)
    pending = (keys >= 0) & (pre == EMPTY)
    hsize = table.table_size
    base = _hash(keys, hsize)
    # one extra entry at index hsize takes every dropped write
    tkeys = torch.cat([table.keys, table.keys.new_full((1,), EMPTY)])
    placed_pos = torch.full_like(base, -1)
    pend = pending
    for j in range(PROBE_WINDOW):
        pos = (base + j) % hsize
        entry = tkeys[pos]
        want = pend & ((entry == EMPTY) | (entry == TOMBSTONE))
        claims = torch.full((hsize + 1,), _INT32_MAX, dtype=torch.int32,
                            device=dev)
        claims.scatter_reduce_(0, torch.where(want, pos, hsize), keys, "amin")
        won = want & (claims[pos] == keys)
        placed_pos = torch.where(won, pos, placed_pos)
        tkeys[torch.where(won, pos, hsize)] = keys
        pend = pend & ~won

    placed = placed_pos >= 0
    rank = torch.cumsum(placed.to(torch.int32), 0, dtype=torch.int32) - 1
    can = placed & (rank < table.n_free)
    cap = table.capacity
    slot_idx = torch.clamp(table.n_free - 1 - rank, 0, cap - 1)
    new_slot = table.free_slots[slot_idx.long()]
    tslots = torch.cat([table.slots, table.slots.new_full((1,), EMPTY)])
    tslots[torch.where(can, placed_pos, hsize)] = new_slot
    rollback = placed & ~can
    tkeys[torch.where(rollback, placed_pos, hsize)] = TOMBSTONE
    n_placed = can.sum(dtype=torch.int32)
    n_fail = pend.sum(dtype=torch.int32) + rollback.sum(dtype=torch.int32)
    out = torch.where(pre >= 0, pre, torch.where(can, new_slot, EMPTY))
    return PatchTable(tkeys[:hsize], tslots[:hsize], table.free_slots,
                      table.n_free - n_placed,
                      table.overflow + n_fail), out


def table_insert_ordered(table: PatchTable, keys):
    """:func:`table_insert` for keys UNIQUE among their non-negative
    entries, computed in vectorised rounds: the same table, slots and
    counters as the sequential insert, key for key.

    Each pending key takes the first free entry of its probe window that
    no earlier placed key takes (the sequential rule). A round recomputes
    every key's entry from the previous round's entries; key ``i`` depends
    only on keys before it, so the rounds reach the sequential answer (the
    one fixed point) after at most ``K`` rounds, in practice after the
    longest chain of keys whose windows overlap, plus one. One host read a
    round (the fixed-point test). The claim rounds of
    :func:`table_insert_unique` differ: a smaller key may take the entry a
    key before it would take.
    """
    keys = keys.to(torch.int32).reshape(-1)
    dev = keys.device
    k = keys.shape[0]
    hsize = table.table_size
    pre = table_lookup(table, keys)
    pend = (keys >= 0) & (pre == EMPTY)
    base, offs, probed = _probe(table.keys, keys)
    free0 = pend[:, None] & ((probed == EMPTY) | (probed == TOMBSTONE))
    entries = (base[:, None] + offs) % hsize                   # [K, W]
    order = torch.arange(k, device=dev)
    big = torch.full_like(entries, PROBE_WINDOW)

    def placement(first):
        cand = first < PROBE_WINDOW
        rank = torch.cumsum(cand.to(torch.int32), 0, dtype=torch.int32) - 1
        placed = cand & (rank < table.n_free)
        pos = (base + torch.clamp(first, max=PROBE_WINDOW - 1)) % hsize
        return placed, rank, pos

    first = torch.where(free0, offs, big).amin(-1)
    while True:
        placed, rank, pos = placement(first)
        claim = torch.full((hsize + 1,), k, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(placed, pos, hsize), order,
                              "amin")
        taken = claim[entries] < order[:, None]
        nxt = torch.where(free0 & ~taken, offs, big).amin(-1)
        if torch.equal(nxt, first):
            break
        first = nxt

    cap = table.capacity
    slot_idx = torch.clamp(table.n_free - 1 - rank, 0, cap - 1)
    new_slot = table.free_slots[slot_idx.long()]
    target = torch.where(placed, pos, hsize)
    tkeys = torch.cat([table.keys, table.keys.new_full((1,), EMPTY)])
    tslots = torch.cat([table.slots, table.slots.new_full((1,), EMPTY)])
    tkeys[target] = keys
    tslots[target] = new_slot
    n_placed = placed.sum(dtype=torch.int32)
    n_fail = (pend & ~placed).sum(dtype=torch.int32)
    out = torch.where(pre >= 0, pre, torch.where(placed, new_slot, EMPTY))
    return PatchTable(tkeys[:hsize], tslots[:hsize], table.free_slots,
                      table.n_free - n_placed,
                      table.overflow + n_fail), out


def active_slot_mask(table: PatchTable):
    """bool[P]: which pool slots are currently allocated (every slot but
    ``free_slots[:n_free]``)."""
    p = table.capacity
    is_free_entry = torch.arange(p, device=table.n_free.device) < table.n_free
    safe = torch.where(is_free_entry, table.free_slots, 0).long()
    in_free = torch.zeros(p, dtype=torch.int32, device=safe.device)
    in_free.scatter_reduce_(0, safe, is_free_entry.to(torch.int32), "amax")
    return in_free == 0


def active_keys(table: PatchTable):
    """(keys int32[P], mask bool[P]): the patch key of every allocated
    slot (EMPTY elsewhere)."""
    p = table.capacity
    valid_entry = table.slots >= 0
    safe_slot = torch.where(valid_entry, table.slots, 0).long()
    contrib = torch.where(valid_entry, table.keys, EMPTY)
    slot_keys = torch.full((p,), EMPTY, dtype=torch.int32,
                           device=contrib.device)
    slot_keys.scatter_reduce_(0, safe_slot, contrib, "amax")
    mask = active_slot_mask(table)
    return torch.where(mask, slot_keys, EMPTY), mask


def _probe(tkeys, keys):
    """(base int64[K], probe offsets, probed keys [K, PROBE_WINDOW]) of
    ``keys`` in the hash-key array ``tkeys``."""
    hsize = tkeys.shape[0]
    base = _hash(keys, hsize)
    offs = torch.arange(PROBE_WINDOW, device=keys.device)
    return base, offs, tkeys[(base[..., None] + offs) % hsize]


def table_insert(table: PatchTable, keys):
    """Sequential insert of ``keys`` (int32[K]; negative entries skipped).

    Returns (table, slots int32[K]): existing or newly allocated slots,
    -1 where the pool is full or the probe window overflows (the sticky
    ``overflow`` counter counts those). Each key sees the writes of the
    keys before it (first free entry of its probe, slot popped off the
    free stack). The JAX package skips the loop when no key is missing;
    the loop changes nothing then, so it always runs here. Every index is
    a one-element tensor: nothing reads back to the host.
    """
    keys = keys.to(torch.int32).reshape(-1)
    out = table_lookup(table, keys).clone()
    tkeys, tslots = table.keys.clone(), table.slots.clone()
    free = table.free_slots
    n_free, ovf = table.n_free.reshape(1), table.overflow.reshape(1)
    hsize = table.table_size
    base, offs, _ = _probe(tkeys, keys)
    for i in range(keys.shape[0]):
        key = keys[i:i + 1]
        probed = tkeys[(base[i] + offs) % hsize]
        first_match = _first(probed == key)
        first_free = _first((probed == EMPTY) | (probed == TOMBSTONE))
        need = (key >= 0) & (out[i:i + 1] == EMPTY)
        already = first_match < PROBE_WINDOW
        pos_match = _entry(base[i], first_match, hsize)
        can_place = (need & ~already & (first_free < PROBE_WINDOW)
                     & (n_free > 0))
        pos_place = _entry(base[i], first_free, hsize)
        new_slot = free[torch.clamp(n_free - 1, min=0).long()]
        tkeys[pos_place] = torch.where(can_place, key, tkeys[pos_place])
        tslots[pos_place] = torch.where(can_place, new_slot, tslots[pos_place])
        n_free = n_free - can_place.to(torch.int32)
        ovf = ovf + (need & ~already & ~can_place).to(torch.int32)
        out[i:i + 1] = torch.where(need & already, tslots[pos_match],
                                   torch.where(can_place, new_slot,
                                               out[i:i + 1]))
    return PatchTable(tkeys, tslots, free, n_free.reshape(()),
                      ovf.reshape(())), out


def _first(hit):
    """[1] int64: the first probe offset where ``hit`` [W] holds,
    PROBE_WINDOW if none."""
    offs = torch.arange(PROBE_WINDOW, device=hit.device)
    return torch.where(hit, offs, PROBE_WINDOW).amin().reshape(1)


def _entry(base, first, hsize: int):
    """[1] int64 hash entry at probe offset ``first`` (clamped into the
    window) from ``base``."""
    return (base + torch.clamp(first, max=PROBE_WINDOW - 1)) % hsize


def table_remove(table: PatchTable, keys):
    """Sequential removal of ``keys`` (int32[K]; negative entries skipped):
    each present key's hash entry becomes a TOMBSTONE and its slot is
    pushed on the free stack. Returns (table, freed slots int32[K], -1
    where the key was absent). reference analogue: map.cpp:465
    ``deletePatchAt``, used by transient maps (slam2d.cpp:323-373). No
    host read, as in :func:`table_insert`."""
    keys = keys.to(torch.int32).reshape(-1)
    tkeys, tslots = table.keys.clone(), table.slots.clone()
    free, n_free = table.free_slots.clone(), table.n_free.reshape(1)
    hsize = table.table_size
    cap = table.capacity
    base, offs, _ = _probe(tkeys, keys)
    freed = torch.full_like(keys, EMPTY)
    for i in range(keys.shape[0]):
        key = keys[i:i + 1]
        probed = tkeys[(base[i] + offs) % hsize]
        first = _first((probed == key) & (key >= 0))
        present = first < PROBE_WINDOW
        pos = _entry(base[i], first, hsize)
        slot = tslots[pos]
        tkeys[pos] = torch.where(present, TOMBSTONE, tkeys[pos])
        tslots[pos] = torch.where(present, EMPTY, tslots[pos])
        push_at = torch.clamp(n_free, max=cap - 1).long()
        free[push_at] = torch.where(present, slot, free[push_at])
        n_free = n_free + present.to(torch.int32)
        freed[i:i + 1] = torch.where(present, slot, EMPTY)
    return table._replace(keys=tkeys, slots=tslots, free_slots=free,
                          n_free=n_free.reshape(())), freed


def table_remove_vec(table: PatchTable, keys):
    """:func:`table_remove` for keys UNIQUE among their non-negative
    entries, vectorised: one probe and three scatters. Distinct present
    keys sit at distinct hash entries, so the scatters commute; the free
    stack takes the freed slots in key order (prefix-sum ranks), as the
    sequential pushes do. Writes that the JAX package drops out of range
    go to one padding entry here, trimmed off."""
    keys = keys.to(torch.int32).reshape(-1)
    hsize = table.table_size
    base, offs, probed = _probe(table.keys, keys)
    big = torch.full_like(probed, PROBE_WINDOW, dtype=torch.int64)
    hit = (probed == keys[:, None]) & (keys[:, None] >= 0)
    first = torch.where(hit, offs, big).amin(-1)
    present = first < PROBE_WINDOW
    pos = (base + torch.clamp(first, max=PROBE_WINDOW - 1)) % hsize
    slot = table.slots[pos]
    target = torch.where(present, pos, hsize)
    tkeys = torch.cat([table.keys, table.keys.new_full((1,), EMPTY)])
    tslots = torch.cat([table.slots, table.slots.new_full((1,), EMPTY)])
    tkeys[target] = TOMBSTONE
    tslots[target] = EMPTY
    cap = table.capacity
    rank = torch.cumsum(present.to(torch.int32), 0, dtype=torch.int32) - 1
    push_at = torch.where(present, table.n_free + rank, cap).long()
    free = torch.cat([table.free_slots, table.free_slots.new_zeros(1)])
    free[push_at] = torch.where(present, slot, 0)
    freed = torch.where(present, slot, EMPTY)
    n_free = table.n_free + present.sum(dtype=torch.int32)
    return table._replace(keys=tkeys[:hsize], slots=tslots[:hsize],
                          free_slots=free[:cap], n_free=n_free), freed
