"""Checkpoint and resume: snapshot closed-loop or study state so a long
scenario study resumes after a failure.

Counterpart of ``pyhybridcontrol_tpu/io/checkpoint.py``. Any nest of
dicts, dataclasses (``ClosedLoopResult``, ``BnbResult``, ...), lists and
tuples whose leaves are tensors, numpy arrays or scalars is flattened in
a fixed order — dict keys sorted, dataclass fields in declaration order,
sequences in order — and written with an atomic write-rename, with a step
counter and user metadata. The file is an 8-byte little-endian length,
that many bytes of JSON (``{"step": ..., "meta": ...}``), then the leaves
as one numpy ``.npz`` archive (``leaf_00000``, ``leaf_00001``, ... in
flattening order; tensors are copied to the host first). The reference
writes its leaves with flax's msgpack, so the two packages do not read
each other's files. Under ``torch.distributed`` with more than one
process, each process writes its own file (``…-procNNN``); restore with
the same process count.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.utils.device import to_numpy


def _children(node):
    """(kind, ordered children) of an inner node of the nest, or None for
    a leaf. None itself is an empty inner node, as in a JAX pytree."""
    if node is None:
        return "none", []
    if isinstance(node, dict):
        return "dict", [node[k] for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return "dataclass", [getattr(node, f.name)
                             for f in dataclasses.fields(node)]
    if isinstance(node, (list, tuple)):
        return "seq", list(node)
    return None


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nest in flattening order."""
    ch = _children(tree)
    if ch is None:
        return [tree]
    return [leaf for c in ch[1] for leaf in tree_leaves(c)]


def _rebuild(target, it):
    """A copy of ``target`` with its leaves taken in order from ``it``;
    each leaf comes back in the kind of the target's leaf (a tensor on its
    device, a numpy array, or a Python scalar)."""
    ch = _children(target)
    if ch is None:
        a = next(it)
        if isinstance(target, torch.Tensor):
            return torch.from_numpy(np.array(a)).to(target.device)
        if isinstance(target, (bool, int, float)):
            return type(target)(a.item())
        return a
    kind, kids = ch
    new = [_rebuild(c, it) for c in kids]
    if kind == "none":
        return None
    if kind == "dict":
        return type(target)(zip(sorted(target), new))
    if kind == "dataclass":
        return dataclasses.replace(
            target, **{f.name: v
                       for f, v in zip(dataclasses.fields(target), new)})
    if hasattr(target, "_fields"):                       # a namedtuple
        return type(target)(*new)
    return type(target)(new)


def _proc_path(path: str, process_index: Optional[int]) -> str:
    if process_index is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        process_index = torch.distributed.get_rank()
    if process_index is not None:
        path = f"{path}-proc{process_index:03d}"
    return path


def save_checkpoint(path: str, state: Any, step: int = 0,
                    metadata: Optional[dict] = None,
                    process_index: Optional[int] = None) -> str:
    """Atomically write ``state`` (any nest of tensors, arrays and
    scalars) to ``path``; returns the path written."""
    path = _proc_path(path, process_index)
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i:05d}": to_numpy(leaf)
                     for i, leaf in enumerate(tree_leaves(state))})
    meta = json.dumps({"step": int(step), "meta": metadata or {}}).encode()
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder)
    try:
        with os.fdopen(fd, "wb") as fp:
            fp.write(len(meta).to_bytes(8, "little"))
            fp.write(meta)
            fp.write(buf.getvalue())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_checkpoint(path: str, target: Any = None,
                    process_index: Optional[int] = None
                    ) -> Tuple[Any, int, dict]:
    """Restore ``(state, step, metadata)``. ``target`` supplies the nest's
    structure (e.g. a freshly initialized state); with ``target=None`` the
    list of leaves is returned as numpy arrays."""
    path = _proc_path(path, process_index)
    with open(path, "rb") as fp:
        mlen = int.from_bytes(fp.read(8), "little")
        meta = json.loads(fp.read(mlen).decode())
        blob = fp.read()
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        leaves = [z[k] for k in sorted(z.files)]
    if target is None:
        return leaves, meta["step"], meta["meta"]
    n_target = len(tree_leaves(target))
    if n_target != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, target expects "
            f"{n_target} — structure mismatch")
    return _rebuild(target, iter(leaves)), meta["step"], meta["meta"]
