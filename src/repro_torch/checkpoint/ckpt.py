"""Step-addressed, async checkpointing with elastic restore — the port of
`repro.checkpoint.ckpt`.

Layout: <dir>/step_<N>/
  arrays.npz       — flattened tree leaves (host-gathered numpy)
  meta.json        — tree structure, step, and the caller's extra dict

A tree is a tensor, a numpy array, a number, or a dict, list or tuple of
trees.  Leaves are flattened in the reference's order (dict keys sorted,
sequences in order), so a layout written by one package reads in the
other's.

Fault-tolerance contract:
  * save is atomic (write to a uniquely-named tmp dir, fsync the payload,
    then publish with one rename) — a crash mid-save never corrupts the
    latest checkpoint; a crash between writing and publishing leaves an
    invisible tmp dir and `restore_latest` falls back to the previous
    complete step (tested under SIGKILL in
    tests/test_torch_checkpoint_fault.py);
  * `restore_latest` finds the newest complete step — restart-after-failure
    is just rerunning the launcher;
  * arrays are saved gathered to the host, so a restore may place them on
    any device and a run may resume onto another shard count
    (`repro_torch.dist.elastic`);
  * async mode snapshots to host memory synchronously (cheap) and writes to
    disk on a background thread.

This module is the one checkpoint writer in the port: `dist/fault.py`'s
`TrainSupervisor` and `dist/elastic.py`'s snapshot loop both delegate here.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# Test/chaos injection point (see repro_torch.dist.chaos.
# install_ckpt_write_crash): called as _crash_hook(stage_name, tmp_dir) at
# "arrays" (payload written), "meta"/"pre_rename" (tmp complete, publish
# pending).  None in production.
_crash_hook = None


def _stage(name: str, tmp_dir: str) -> None:
    if _crash_hook is not None:
        _crash_hook(name, tmp_dir)


def _flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure): dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        leaves, spec = [], []
        for k in sorted(tree):
            sub, s = _flatten(tree[k])
            leaves += sub
            spec.append((k, s))
        return leaves, ("dict", spec)
    if isinstance(tree, (list, tuple)):
        leaves, spec = [], []
        for x in tree:
            sub, s = _flatten(x)
            leaves += sub
            spec.append(s)
        return leaves, (type(tree).__name__, spec)
    return [tree], "leaf"


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s == "leaf":
            return next(it)
        kind, parts = s
        if kind == "dict":
            return {k: build(sub) for k, sub in parts}
        seq = [build(sub) for sub in parts]
        return tuple(seq) if kind == "tuple" else seq

    return build(spec)


def _retype(like, tree):
    """`tree` with the named tuples of `like` (its structure) rebuilt as
    such: the spec keeps a sequence's kind, not its type."""
    if isinstance(like, dict):
        return {k: _retype(like[k], v) for k, v in tree.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_retype(l, t) for l, t in zip(like, tree)))
    if isinstance(like, (list, tuple)):
        return type(tree)(_retype(l, t) for l, t in zip(like, tree))
    return tree


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         async_write: bool = False):
    """Checkpoint `tree` at `step`.  Returns the writer thread in async
    mode (join it), else None."""
    flat, spec = _flatten(tree)
    # snapshot to the host synchronously: the caller may overwrite its
    # tensors in place on the next step
    host = [np.array(_host(x), copy=True) for x in flat]
    meta = {"step": int(step), "n_leaves": len(host), "treedef": repr(spec),
            "extra": extra or {}}

    def write():
        # unique tmp name: concurrent/crashed writers of the same step can
        # never interleave inside one tmp dir
        tmp = os.path.join(
            ckpt_dir, f".tmp_step_{step}_{os.getpid()}_{uuid.uuid4().hex[:8]}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as fh:
            np.savez(fh, **{f"leaf_{i}": a for i, a in enumerate(host)})
            fh.flush()
            os.fsync(fh.fileno())
        _stage("arrays", tmp)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _stage("meta", tmp)
        if os.path.exists(final):
            # swap, don't rmtree-then-rename: a crash between the two
            # renames hides step N, but the older steps stay restorable
            old = os.path.join(
                ckpt_dir, f".old_step_{step}_{uuid.uuid4().hex[:8]}")
            os.rename(final, old)
        else:
            old = None
        _stage("pre_rename", tmp)
        os.rename(tmp, final)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)

    if async_write:
        t = threading.Thread(target=write)
        t.start()
        return t
    write()
    return None


def available_steps(ckpt_dir: str):
    """The complete steps in `ckpt_dir` (those with a meta.json), sorted."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_"):
            continue
        try:
            step = int(d.split("_", 1)[1])
        except ValueError:          # foreign/garbage entry — not a checkpoint
            continue
        if os.path.exists(os.path.join(ckpt_dir, d, "meta.json")):
            steps.append(step)
    return sorted(steps)


def prune(ckpt_dir: str, keep: int = 2) -> None:
    """Drop all but the newest `keep` complete steps, plus any stale tmp/old
    dirs left behind by crashed writers (their unique names make them dead
    the moment their writer is)."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = available_steps(ckpt_dir)
    drop = steps[:-keep] if keep > 0 else steps
    for s in drop:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
    for d in os.listdir(ckpt_dir):
        if d.startswith(".tmp_step_") or d.startswith(".old_step_"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def restore(ckpt_dir: str, step: int, like_tree, device=None):
    """Restore step `step` into the structure of `like_tree` (only its
    structure is read; its named tuples, such as an optimizer state, come
    back as such), as tensors on `device` (None: the card, as every entry
    point of the port).  Returns (tree, extra)."""
    from repro_torch.core.ensemble import resolve_device
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    flat_like, spec = _flatten(like_tree)
    assert meta["n_leaves"] == len(flat_like), (
        f"checkpoint has {meta['n_leaves']} leaves, model expects "
        f"{len(flat_like)} — architecture mismatch")
    dev = resolve_device(device)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        out = [torch.from_numpy(data[f"leaf_{i}"]).to(dev)
               for i in range(len(flat_like))]
    return _retype(like_tree, _unflatten(spec, out)), meta["extra"]


def restore_latest(ckpt_dir: str, like_tree, device=None):
    """(step, tree, extra) of the newest complete step, or None."""
    steps = available_steps(ckpt_dir)
    if not steps:
        return None
    tree, extra = restore(ckpt_dir, steps[-1], like_tree, device)
    return steps[-1], tree, extra
