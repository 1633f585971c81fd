"""Atomic, self-validating checkpoints in the reference's on-disk format.

The format of the reference's ``training/checkpoint.py``, written and
read with numpy alone, so that either package restores what the other
saved:

  - ``<dir>/step_%08d/`` holds ``arrays.npz`` and ``manifest.json``; both
    are written into ``<dir>/tmp.*`` and the directory is renamed into
    place only once the manifest is fsync'd, so a preempted writer never
    corrupts the latest checkpoint; ``keep`` bounds how many stay;
  - array ``a{i}`` is the i-th leaf in the reference's flattening order
    (``repro_torch.tree``: dict keys sorted, sequences in order, ``None``
    dropped), compressed containers counting as one leaf; its manifest
    entry holds its ``path`` (keys joined by ``/``) and ``kind``
    (``array``, ``qtensor``, ``blocksparse``, ``qembed``), with the container's
    static fields; ``structure_only`` lists the empty containers and
    ``None`` leaves that flattening drops; ``extra`` is the caller's
    JSON; ``sha256`` hashes ``arrays.npz`` and is checked on load;
  - bf16 arrays are stored as their ``uint16`` bits and listed under the
    manifest's ``bf16``; they are read back through
    ``torch.from_numpy(a).view(torch.bfloat16)``.

A ``QTensor`` is one entry whatever its leading axes (a layer, and an
MoE stack's expert axis), as in the reference.  A layer-stacked
``BlockSparseTensor`` is written as the reference holds it, without its
gather indices; on load ``idx`` is rebuilt from ``mask``
per layer.  A ``QEmbed`` (the int8 embedding table) is a ``qembed``
entry of two arrays, ``.q`` and ``.scale``, as in the reference.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compressed import (BlockSparseTensor, QEmbed, QTensor, ShardedTensor,
                                         check_idx)
from repro_torch.kernels.backend import resolve_device
from repro_torch.tree import flatten_with_path, unflatten_like

_CONTAINERS = (QTensor, BlockSparseTensor, QEmbed)


def _is_container(x) -> bool:
    return isinstance(x, _CONTAINERS)


def _flatten(tree):
    return flatten_with_path(tree, is_leaf=_is_container)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _record_structure_only(tree, path, out) -> None:
    """Collect the tree nodes a leaf-path manifest cannot represent:
    empty dicts/lists/tuples and ``None`` leaves, which flattening drops.
    ``restore`` never needs this (its ``target`` carries the structure);
    ``restore_tree`` re-inserts them."""
    if tree is None:
        out.append({"path": "/".join(path), "kind": "none"})
    elif _is_container(tree):
        pass
    elif isinstance(tree, dict):
        if not tree:
            out.append({"path": "/".join(path), "kind": "dict"})
        for k, v in tree.items():
            _record_structure_only(v, path + [str(k)], out)
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out.append({"path": "/".join(path), "kind": "list"})
        for i, v in enumerate(tree):
            _record_structure_only(v, path + [str(i)], out)


def _np(t) -> Tuple[np.ndarray, bool]:
    """(a tensor as a host numpy array, whether it is bf16); bf16 keeps
    its bits as a ``uint16`` view."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def _whole(leaf, path) -> torch.Tensor:
    """A sharded leaf of tensor pieces gathered whole on the host."""
    from repro_torch.distributed.sharding import gather
    if not all(torch.is_tensor(t) for t in leaf.tensors()):
        raise NotImplementedError(f"{_path_str(path)}: a sharded leaf of compressed pieces "
                                  "is not written; save it before placing it")
    return gather(leaf, torch.device("cpu"))


def save(ckpt_dir: str, step: int, state, *, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Write ``state`` (a tree of tensors, compressed containers included).
    A sharded leaf (``ShardedTensor`` of tensor pieces, as a placed train
    state holds) is written gathered whole, so the checkpoint is the one
    its unsharded tree writes: either package's ``restore`` reads it, and
    ``restore(..., shardings=)`` places it onto any layout."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(state)
    tmp = tempfile.mkdtemp(prefix="tmp.", dir=ckpt_dir)
    manifest: Dict[str, Any] = {"step": int(step), "arrays": {},
                                "extra": extra or {}}
    structure_only: list = []
    _record_structure_only(state, [], structure_only)
    if structure_only:
        manifest["structure_only"] = structure_only
    arrays: Dict[str, Tuple[np.ndarray, bool]] = {}
    for i, (path, leaf) in enumerate(flat):
        name = f"a{i}"
        if isinstance(leaf, ShardedTensor):
            leaf = _whole(leaf, path)
        meta: Dict[str, Any] = {"path": _path_str(path)}
        if isinstance(leaf, QTensor):
            meta["kind"] = "qtensor"
            meta["bits"], meta["group"] = leaf.bits, leaf.group
            meta["shape"] = list(leaf.shape)
            arrays[name + ".q"] = _np(leaf.q)
            arrays[name + ".scale"] = _np(leaf.scale)
            meta["has_in_scale"] = leaf.in_scale is not None
            if leaf.in_scale is not None:
                arrays[name + ".in_scale"] = _np(leaf.in_scale)
        elif isinstance(leaf, BlockSparseTensor):
            meta["kind"] = "blocksparse"
            meta["bs"] = leaf.bs
            arrays[name + ".w"] = _np(leaf.w)
            arrays[name + ".mask"] = _np(leaf.mask)
            # the reference keeps indices on a single matrix only
            has_idx = leaf.w.dim() == 2
            meta["has_idx"] = has_idx
            if has_idx:
                arrays[name + ".idx"] = _np(leaf.idx)
        elif isinstance(leaf, QEmbed):
            meta["kind"] = "qembed"
            arrays[name + ".q"] = _np(leaf.q)
            arrays[name + ".scale"] = _np(leaf.scale)
        else:
            meta["kind"] = "array"
            arrays[name] = _np(leaf)
        manifest["arrays"][name] = meta

    npz_path = os.path.join(tmp, "arrays.npz")
    for k, (_, bf16) in arrays.items():
        if bf16:
            manifest.setdefault("bf16", []).append(k)
    np.savez(npz_path, **{k: a for k, (a, _) in arrays.items()})
    with open(npz_path, "rb") as f:
        manifest["sha256"] = hashlib.sha256(f.read()).hexdigest()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _open(ckpt_dir: str, step: Optional[int], verify: bool):
    """(step, manifest, get) of a checkpoint; ``get(name)`` is the stored
    array as a CPU tensor."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    npz_path = os.path.join(d, "arrays.npz")
    if verify:
        with open(npz_path, "rb") as f:
            h = hashlib.sha256(f.read()).hexdigest()
        if h != manifest["sha256"]:
            raise IOError(f"checkpoint {d} corrupt: hash mismatch")
    data = np.load(npz_path)
    bf16 = set(manifest.get("bf16", []))

    def get(name) -> torch.Tensor:
        a = np.array(data[name], order="C")          # a writable copy
        if name in bf16:
            return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    return step, manifest, get


def _leaf_from_meta(meta, name, get, device):
    """One manifest entry -> its leaf on ``device`` (shared by both
    restores)."""
    kind = meta["kind"]
    if kind == "qtensor":
        return QTensor(get(name + ".q").to(device), get(name + ".scale").to(device),
                       meta["bits"], meta["group"], tuple(meta["shape"]),
                       get(name + ".in_scale").to(device)
                       if meta.get("has_in_scale") else None)
    if kind == "blocksparse":
        w = get(name + ".w").to(device)
        idx = (check_idx(get(name + ".idx").to(device), w.shape, meta["bs"])
               if meta.get("has_idx") else None)
        return BlockSparseTensor(w, get(name + ".mask").to(device), meta["bs"], idx)
    if kind == "qembed":
        return QEmbed(get(name + ".q").to(device), get(name + ".scale").to(device))
    if kind != "array":
        raise ValueError(f"unknown checkpoint entry kind {kind!r}")
    return get(name).to(device)


def restore(ckpt_dir: str, target, *, step: Optional[int] = None,
            shardings=None, verify: bool = True, device="cuda") -> Tuple[Any, int, Dict]:
    """Rebuild ``target``-structured state from disk onto ``device``.

    ``target``: a tree with the desired structure (its leaves only name
    positions; their values are not read).  ``shardings``: a matching
    tree of ``distributed/sharding.py`` ``NamedSharding``s (as
    ``param_shardings`` gives; ``None`` leaves a leaf on ``device``): the
    restored leaves are then placed on their mesh (``sharding.place``),
    so a checkpoint written on one layout is read onto another (the
    reference's elastic re-shard)."""
    dev = resolve_device(device)
    step, manifest, get = _open(ckpt_dir, step, verify)
    n = len(_flatten(target))
    if n != len(manifest["arrays"]):
        raise ValueError(f"target has {n} leaves, checkpoint {len(manifest['arrays'])}")
    leaves = [_leaf_from_meta(manifest["arrays"][f"a{i}"], f"a{i}", get, dev)
              for i in range(n)]
    state = unflatten_like(target, leaves, is_leaf=_is_container)
    if shardings is not None:
        from repro_torch.distributed.sharding import place
        state = place(state, shardings)
    return state, step, manifest.get("extra", {})


def restore_tree(ckpt_dir: str, *, step: Optional[int] = None,
                 verify: bool = True, device="cuda") -> Tuple[Any, int, Dict]:
    """Structure-free restore: rebuild the tree from the manifest's
    recorded key paths alone, no ``target`` template needed (a service
    restarting warm reloads compressed models it never built in this
    process).  Dicts whose keys are exactly ``0..n-1`` (as strings) were
    sequences and come back as lists."""
    dev = resolve_device(device)
    step, manifest, get = _open(ckpt_dir, step, verify)
    extra = manifest.get("extra", {})
    root: Dict[str, Any] = {}

    def insert(parts, value):
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for name, meta in manifest["arrays"].items():
        parts = meta["path"].split("/") if meta["path"] else []
        leaf = _leaf_from_meta(meta, name, get, dev)
        if not parts:               # scalar/array state: the tree IS it
            return leaf, step, extra
        insert(parts, leaf)
    for s in manifest.get("structure_only", []):
        value = {"none": None, "dict": {}, "list": []}[s["kind"]]
        parts = s["path"].split("/") if s["path"] else []
        if not parts:
            return value, step, extra
        insert(parts, value)

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        keys = list(out)
        if keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(idx))):
                return [out[str(i)] for i in idx]
        return out

    return listify(root), step, extra


def atomic_write_json(path: str, obj: Any) -> None:
    """Crash-safe JSON write: a temp file in the destination directory,
    flush + fsync, then ``os.replace``; readers see the old or the whole
    new content."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp.", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


__all__ = ["atomic_write_json", "latest_step", "restore", "restore_tree", "save"]
