"""Atomic, manifest-driven checkpoints (port of
``repro/train/checkpoint.py``), in the reference's on-disk format:

  * atomic: leaves are written to ``step_N.tmp/`` which is then renamed
    to ``step_N/``; stale ``.tmp`` directories of crashed saves are swept,
  * manifest-driven: ``manifest.json`` records ``step``, ``n_leaves``,
    each leaf's ``name``/``shape``/``dtype``/``sha256[:16]`` and the
    caller's ``meta``,
  * retention: keep the last ``keep`` published steps,
  * integrity: per-leaf checksums validated on load.

A tree is nested dicts, lists and tuples of arrays (numpy, tensors or
scalars).  Its leaves are numbered in the reference's flattening order
(dict keys sorted, lists and tuples in order, ``None`` an empty
subtree), so a checkpoint written by either package restores in the
other.  ``treedef`` in the manifest is informational: restore reads the
structure from ``tree_like``.

A leaf placed on a mesh (``distributed.sharding.Placed``) is saved whole,
so its files are those of the unsharded tree, byte for byte; restore with
``shardings=`` places each leaf on the current mesh, whatever mesh it was
saved from (the elastic rescale: save on one mesh shape, resume on
another).
"""
from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.distributed.sharding import Placed, place


def _flatten(tree):
    """-> (leaves, treedef string); dict keys visit in sorted order, so
    the string keys ``"10"`` < ``"3"``, as in the reference."""
    leaves = []

    def walk(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            keys = sorted(node)
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in keys) + "}"
        if isinstance(node, (list, tuple)):
            inner = [walk(x) for x in node]
            if isinstance(node, list):
                return "[" + ", ".join(inner) + "]"
            return "(" + ", ".join(inner) + ("," if len(inner) == 1
                                              else "") + ")"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(tree_like, leaves):
    """Rebuild ``tree_like``'s structure with ``leaves`` in flatten
    order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(tree_like)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, Placed):                # gathered whole
        return leaf.full(torch.device("cpu")).numpy()
    if hasattr(leaf, "detach"):                 # a torch tensor
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_name(i):
    return f"leaf_{i:05d}.npy"


def _steps(ckpt_dir: Path) -> list:
    return [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
            if p.is_dir() and p.name.startswith("step_")
            and not p.name.endswith(".tmp")]


def save_checkpoint(ckpt_dir, step: int, tree, *, keep: int = 3,
                    extra_meta: dict = None):
    """Publish ``tree`` as ``ckpt_dir/step_{step:08d}/``; returns its
    path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, treedef = _flatten(tree)
    manifest = {
        "step": step,
        "treedef": treedef,
        "n_leaves": len(leaves),
        "leaves": [],
        "meta": extra_meta or {},
    }
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        path = tmp / _leaf_name(i)
        np.save(path, arr, allow_pickle=False)
        manifest["leaves"].append({
            "name": _leaf_name(i),
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(path.read_bytes()).hexdigest()[:16],
        })
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic publish

    # sweep stale tmp dirs of crashed saves (ours was just renamed away;
    # retention below only considers published steps)
    for p in ckpt_dir.glob("step_*.tmp"):
        shutil.rmtree(p, ignore_errors=True)

    for s in sorted(_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
    return final


def latest_step(ckpt_dir):
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def checkpoint_meta(ckpt_dir, *, step: int = None):
    """A checkpoint's manifest ``meta`` without loading any leaf ->
    ``(meta, step)``: restore paths whose ``tree_like`` depends on the
    saved structure (the pipeline's coverage patterns) read it first."""
    ckpt_dir = Path(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    manifest = json.loads(
        (ckpt_dir / f"step_{step:08d}" / "manifest.json").read_text())
    return manifest["meta"], step


def _like(leaf) -> tuple:
    """A ``tree_like`` leaf's (shape, numpy dtype), without gathering a
    placed one."""
    if isinstance(leaf, Placed):
        return (tuple(leaf.shape),
                torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    a = _host(leaf)
    return tuple(a.shape), a.dtype


def restore_checkpoint(ckpt_dir, tree_like, *, step: int = None,
                       shardings=None, cast: bool = False):
    """Restore into the structure of ``tree_like`` ->
    ``(tree, step, meta)``.

    Leaves come back as host numpy arrays in their exact checkpoint
    dtype.  A dtype other than ``tree_like``'s raises ``TypeError``
    (a float64 carry restored into float32 would round and break the
    exact left folds downstream) unless ``cast=True`` asks for an
    explicit ``astype``; a checksum mismatch raises ``IOError``.

    ``shardings``: a tree shaped like ``tree_like`` of
    ``distributed.sharding.Sharding`` (or None a leaf) for the current
    mesh; each leaf comes back placed by its sharding
    (``sharding.place``: a 0-d leaf a tensor on the mesh's first
    device), whatever mesh saved it.
    """
    ckpt_dir = Path(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())

    leaves_like, _ = _flatten(tree_like)
    assert manifest["n_leaves"] == len(leaves_like), \
        f"checkpoint has {manifest['n_leaves']} leaves, " \
        f"model expects {len(leaves_like)}"
    placing = (_flatten(shardings)[0] if shardings is not None
               else [None] * len(leaves_like))
    if len(placing) != len(leaves_like):
        raise ValueError(f"shardings has {len(placing)} leaves, the tree "
                         f"{len(leaves_like)}")
    out = []
    for i, (like, rec) in enumerate(zip(leaves_like, manifest["leaves"])):
        path = d / rec["name"]
        digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
        if digest != rec["sha256"]:
            raise IOError(f"checksum mismatch for {path}")
        arr = np.load(path, allow_pickle=False)
        shape, want = _like(like)
        assert list(arr.shape) == list(shape), \
            f"leaf {i}: {arr.shape} vs expected {shape}"
        if arr.dtype != want:
            if not cast:
                raise TypeError(
                    f"leaf {i} ({rec['name']}): checkpoint dtype "
                    f"{arr.dtype} != expected {want} — pass cast=True "
                    f"to convert explicitly")
            arr = arr.astype(want)
        out.append(arr if placing[i] is None
                   else place(torch.from_numpy(arr), placing[i]))
    return _unflatten(tree_like, out), step, manifest["meta"]
