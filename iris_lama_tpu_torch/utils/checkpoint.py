"""Full-state checkpoint and resume.

reference: the C++ library persists only maps (versioned .smd,
src/sdm/map.cpp:490-575); poses and filter state are not checkpointed.
Here any nest of dicts, lists, tuples and NamedTuples whose leaves are
tensors or arrays (a ``SlamMapState``, a particle set, a state dict of
``utils/state.py``) round-trips through one archive.

Format, shared with the JAX package (either package loads the other's
files): a ``.npz`` whose entries are the leaves in the JAX tree order
(dict keys sorted, sequences and NamedTuple fields in order; None holds no
leaf), named ``NNNN:path`` with the path's parts joined by ``/``;
optionally compressed as ``b"LMC1"`` + u64 little-endian raw size + the
npz bytes as one lz4 block (``utils/codec.py``).
"""

from __future__ import annotations

import io
from typing import Any

import numpy as np
import torch

from .codec import BufferCompressor

MAGIC = b"LMC1"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=()):
    """[(path parts, leaf)] in the JAX package's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in _flatten(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [e for f in tree._fields
                for e in _flatten(getattr(tree, f), path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [e for i, v in enumerate(tree)
                for e in _flatten(v, path + (str(i),))]
    return [(path, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _as_like(arr: np.ndarray, ref):
    """``arr`` in the type, dtype and device of the leaf ``ref``."""
    if isinstance(ref, torch.Tensor):
        np_dtype = torch.empty(0, dtype=ref.dtype).numpy().dtype
        return torch.as_tensor(arr.astype(np_dtype), device=ref.device)
    if hasattr(ref, "dtype"):
        return arr.astype(ref.dtype)
    return arr


def save_state(path: str, tree: Any, compress: bool = False) -> None:
    """Write ``tree``'s leaves to ``path`` (lz4-compressed with
    ``compress``)."""
    arrays = {f"{i:04d}:{'/'.join(p) or 'leaf'}": _host(leaf)
              for i, (p, leaf) in enumerate(_flatten(tree))}
    if not compress:
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        return
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    raw = buf.getvalue()
    comp = BufferCompressor("lz4").compress(raw)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(raw).to_bytes(8, "little"))
        f.write(comp)


def load_state(path: str, like: Any) -> Any:
    """Load a checkpoint into the structure of ``like``: tensor leaves come
    back as tensors of ``like``'s dtype and device, array leaves as numpy
    arrays of its dtype."""
    with open(path, "rb") as f:
        head = f.read(4)
        if head == MAGIC:
            raw_len = int.from_bytes(f.read(8), "little")
            raw = BufferCompressor("lz4").decompress(f.read(), raw_len)
            src = io.BytesIO(raw)
        else:
            f.seek(0)
            src = io.BytesIO(f.read())
    with np.load(src) as data:
        leaves = [data[k] for k in sorted(data.files)]
    refs = [leaf for _, leaf in _flatten(like)]
    if len(leaves) != len(refs):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, the "
                         f"structure needs {len(refs)}")
    return _unflatten(like, iter(_as_like(a, r)
                                 for a, r in zip(leaves, refs)))
