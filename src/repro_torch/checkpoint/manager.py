"""Fault-tolerant checkpointing; the port of ``repro.checkpoint.manager``.

Layout (one directory per step)::

    <root>/step_000120/
        manifest.json        # tree layout, leaf paths, shapes, dtypes, hash
        arrays.npz           # one entry per leaf
    <root>/LATEST            # atomic pointer file

Writes are two-phase (tmp dir + ``os.replace``), so a preempted writer
never corrupts the latest checkpoint: the restart path finds either the
previous step or the completed new one.

A tree is nested dicts, lists and tuples whose leaves are numpy arrays,
torch tensors or scalars (``None`` is an empty subtree).  It is
flattened in the reference's (jax's) leaf order, dict keys sorted, and
the manifest carries the same ``treedef`` text, ``leaf_paths``,
``leaf_%05d`` keys and content hash, so a checkpoint written by either
package loads in the other.  :func:`restore_checkpoint` places the leaves
on one torch device, or, with ``mesh=`` and ``specs=``, lays each leaf
that has a spec over the mesh's devices as a
:class:`repro_torch.sharding.ShardedTensor` (an elastic restore onto
another mesh).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..sharding.mesh import BankMesh, PartitionSpec, shard_tensor

__all__ = ["save_checkpoint", "restore_checkpoint", "load_checkpoint_tree",
           "CheckpointManager"]

_STEP_RE = re.compile(r"step_(\d+)$")


def _leaf_key(i: int) -> str:
    return f"leaf_{i:05d}"


def _flatten(tree: Any, path: Tuple = ()) -> Tuple[List[Any], str,
                                                   List[Tuple]]:
    """(leaves, treedef text, key path of each leaf) of ``tree`` in jax's
    order: dict keys sorted, list and tuple items in order, ``None`` an
    empty subtree.  A key path holds a dict key, or ``None`` for a list or
    tuple position."""
    if tree is None:
        return [], "None", []
    if isinstance(tree, dict):
        leaves, defs, paths = [], [], []
        for key in sorted(tree):
            lv, d, ps = _flatten(tree[key], path + (key,))
            leaves += lv
            defs.append(f"{key!r}: {d}")
            paths += ps
        return leaves, "{" + ", ".join(defs) + "}", paths
    if isinstance(tree, (list, tuple)):
        leaves, defs, paths = [], [], []
        for item in tree:
            lv, d, ps = _flatten(item, path + (None,))
            leaves += lv
            defs.append(d)
            paths += ps
        if isinstance(tree, list):
            return leaves, "[" + ", ".join(defs) + "]", paths
        body = defs[0] + "," if len(defs) == 1 else ", ".join(defs)
        return leaves, "(" + body + ")", paths
    return [tree], "*", [path]


def _unflatten(target: Any, leaves) -> Any:
    """``target``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if target is None:
        return None
    if isinstance(target, dict):
        out = {key: _unflatten(target[key], leaves)
               for key in sorted(target)}
        return {key: out[key] for key in target}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten(item, leaves) for item in target)
    return next(leaves)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_paths(paths: List[Tuple]) -> Optional[List[str]]:
    """Flattened "a/b/c" key paths when every container in the tree is a
    dict (the self-describing case a target-free restore can rebuild);
    None for any other tree."""
    if any(k is None for p in paths for k in p):
        return None
    return ["/".join(str(k) for k in p) for p in paths]


def save_checkpoint(root: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None) -> str:
    """Two-phase atomic write.  Returns the checkpoint directory."""
    os.makedirs(root, exist_ok=True)
    leaves, treedef, paths = _flatten(tree)
    arrays = {_leaf_key(i): _to_numpy(leaf) for i, leaf in enumerate(leaves)}

    tmp = tempfile.mkdtemp(dir=root, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        digest = hashlib.sha256()
        for k in sorted(arrays):
            digest.update(k.encode())
            digest.update(np.ascontiguousarray(arrays[k]).tobytes()[:4096])
        manifest = {
            "step": int(step),
            "treedef": f"PyTreeDef({treedef})",
            "n_leaves": len(leaves),
            "shapes": [list(a.shape) for a in arrays.values()],
            "dtypes": [str(a.dtype) for a in arrays.values()],
            # present iff the tree is dict-nested: lets a reader rebuild
            # the tree WITHOUT a matching target (the recovery path,
            # where leaf shapes depend on the state being recovered).
            "leaf_paths": _leaf_paths(paths),
            "metadata": metadata or {},
            "content_hash": digest.hexdigest(),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        final = os.path.join(root, f"step_{step:06d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    fd, ptr_tmp = tempfile.mkstemp(dir=root)
    with os.fdopen(fd, "w") as f:
        f.write(f"step_{step:06d}")
    os.replace(ptr_tmp, os.path.join(root, "LATEST"))
    return final


def _verify(manifest: Dict, arrays) -> None:
    digest = hashlib.sha256()
    for k in sorted(arrays.files):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(arrays[k]).tobytes()[:4096])
    if digest.hexdigest() != manifest["content_hash"]:
        raise IOError("checkpoint content hash mismatch (corrupt write?)")


def _complete_steps(root: str) -> List[int]:
    """Step numbers whose directory holds a manifest, i.e. checkpoints
    whose two-phase write COMPLETED.  A step dir without a manifest is a
    torn artifact (an interrupted writer, a partial copy) and is never
    selected for restore."""
    out = []
    for d in os.listdir(root):
        m = _STEP_RE.search(d)
        if m and os.path.isfile(os.path.join(root, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def _resolve_step_dir(root: str, step: Optional[int]) -> str:
    """Checkpoint dir for ``step`` (latest when None).  The LATEST
    pointer is a hint: if it is missing or names a dir without a manifest
    (torn write, pointer from a crashed writer), fall back to the newest
    COMPLETE step dir."""
    if step is not None:
        return os.path.join(root, f"step_{step:06d}")
    try:
        with open(os.path.join(root, "LATEST")) as f:
            d = f.read().strip()
        if os.path.isfile(os.path.join(root, d, "manifest.json")):
            return os.path.join(root, d)
    except FileNotFoundError:
        pass
    steps = _complete_steps(root)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint under {root}")
    return os.path.join(root, f"step_{steps[-1]:06d}")


def _torch_dtype(tgt: Any):
    """The torch dtype of a target leaf: a tensor's own, or that of a
    numpy array's (or any object with a numpy ``dtype``)."""
    if isinstance(tgt, torch.Tensor):
        return tgt.dtype
    return torch.from_numpy(np.zeros((), np.dtype(tgt.dtype))).dtype


def _spec_leaves(target: Any, specs: Any) -> List[Optional[PartitionSpec]]:
    """The spec of each leaf of ``target``, in ``_flatten``'s order.
    ``specs`` mirrors ``target``'s containers down to where a spec (a
    :class:`PartitionSpec`, or a tuple or list of axis names at a leaf)
    or None stands, which then covers every leaf beneath it."""
    if specs is None or isinstance(specs, PartitionSpec):
        return [specs] * len(_flatten(target)[0])
    if isinstance(target, dict):
        if not isinstance(specs, dict) or set(specs) != set(target):
            raise ValueError(f"specs {specs!r} do not match the target's "
                             f"keys {sorted(target)}")
        return [s for key in sorted(target)
                for s in _spec_leaves(target[key], specs[key])]
    if isinstance(target, (list, tuple)):
        if not isinstance(specs, (list, tuple)) \
                or len(specs) != len(target):
            raise ValueError(f"specs {specs!r} do not match a target "
                             f"sequence of {len(target)}")
        return [s for t, sp in zip(target, specs)
                for s in _spec_leaves(t, sp)]
    if target is None:
        return []
    if not isinstance(specs, (list, tuple)):
        raise ValueError(f"spec {specs!r} for a leaf: expected a "
                         "PartitionSpec, a tuple of axis names or None")
    return [PartitionSpec(*specs)]


def restore_checkpoint(root: str, target: Any, step: Optional[int] = None,
                       mesh: Optional[BankMesh] = None, specs: Any = None,
                       verify: bool = True,
                       device: Union[str, torch.device, None] = None
                       ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target`` (a tree of tensors, numpy
    arrays, or anything with ``shape`` and ``dtype``), each leaf a tensor
    of the target leaf's dtype on ``device`` (CUDA unless the caller
    passes another; the mesh's first device when ``mesh`` is given).

    With ``mesh`` (a 1-D :class:`repro_torch.sharding.BankMesh`) and
    ``specs`` (a tree mirroring ``target``, see :func:`_spec_leaves`),
    each leaf with a spec comes back as a
    :class:`repro_torch.sharding.ShardedTensor` laid over the mesh: split
    along the dim its spec names by the mesh's axis, or replicated when
    the spec names none (``PartitionSpec()`` or all None).  A leaf with
    no spec (None) is restored as without a mesh.  As in the reference,
    ``specs`` without ``mesh`` place nothing."""
    dev = mesh.primary if mesh is not None and device is None \
        else resolve_device(device)
    path = _resolve_step_dir(root, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = np.load(os.path.join(path, "arrays.npz"))
    if verify:
        _verify(manifest, arrays)

    leaves, _, _ = _flatten(target)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"leaf count mismatch: target {len(leaves)} vs "
                         f"checkpoint {manifest['n_leaves']}")
    spec_leaves = _spec_leaves(target, specs) if mesh is not None \
        else [None] * len(leaves)
    out = []
    for i, (tgt, spec) in enumerate(zip(leaves, spec_leaves)):
        a = arrays[_leaf_key(i)]
        if tuple(a.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch at leaf {i}: {a.shape} vs "
                             f"{tuple(tgt.shape)}")
        t = torch.tensor(a).to(device=dev, dtype=_torch_dtype(tgt))
        out.append(t if spec is None else shard_tensor(t, mesh, spec))
    return _unflatten(target, iter(out)), manifest


def load_checkpoint_tree(root: str, step: Optional[int] = None,
                         verify: bool = True) -> Tuple[Dict, Dict]:
    """Target-free restore of a dict-nested checkpoint: rebuild the
    nested dict from the manifest's ``leaf_paths`` with host numpy
    leaves.  This is the crash-recovery entry point: the restorer cannot
    supply a shape-matching target, because the leaf shapes (slot
    capacity, packed bank width, per-job buffers) are the crashed state
    being recovered.  Returns ``(tree, manifest)``."""
    path = _resolve_step_dir(root, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("leaf_paths") is None:
        raise ValueError(
            "checkpoint was not saved from a dict-nested tree; use "
            "restore_checkpoint with a target instead")
    arrays = np.load(os.path.join(path, "arrays.npz"))
    if verify:
        _verify(manifest, arrays)
    tree: Dict = {}
    for i, p in enumerate(manifest["leaf_paths"]):
        node = tree
        parts = p.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.array(arrays[_leaf_key(i)])
    return tree, manifest


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints, exposes resume."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def steps(self) -> List[int]:
        """COMPLETE checkpoint steps only: a step dir without its
        manifest (interrupted writer) is invisible here, so
        ``latest_step()`` never selects a torn checkpoint."""
        return _complete_steps(self.root)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None) -> str:
        path = save_checkpoint(self.root, step, tree, metadata)
        self._gc()
        return path

    def restore(self, target: Any, step: Optional[int] = None,
                mesh: Optional[BankMesh] = None, specs: Any = None,
                device: Union[str, torch.device, None] = None
                ) -> Tuple[Any, Dict]:
        return restore_checkpoint(self.root, target, step=step, mesh=mesh,
                                  specs=specs, device=device)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:06d}"),
                          ignore_errors=True)
        for d in os.listdir(self.root):
            full = os.path.join(self.root, d)
            # torn artifacts from interrupted writers: orphaned two-phase
            # tmp dirs (no live save holds one here: _gc runs between
            # saves) and manifest-less step dirs steps() refuses to list.
            if d.startswith(".tmp_ckpt_") and os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            m = _STEP_RE.search(d)
            if m and os.path.isdir(full) and \
                    not os.path.isfile(os.path.join(full, "manifest.json")):
                shutil.rmtree(full, ignore_errors=True)
