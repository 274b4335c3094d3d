"""Atomic checkpoints of named trees (counterpart of `repro.train.checkpoint`).

- SAVE: every leaf is one plain `.npy` under a step directory, beside a
  JSON manifest (step, each tree's leaf shapes and dtypes, and the
  caller's `extra`). The directory is staged as `<step>.tmp` and renamed,
  so a crash mid-save never touches the latest complete checkpoint.
- ASYNC: `AsyncSaver` copies the trees to host numpy on the call and
  writes them on a thread; a write that fails is raised again from the
  next `wait()` or `save()`.
- RESTORE: leaves come back as host numpy in the templates' structure;
  the caller places them on its device (`KmerCounter.restore` does, and
  reshards the count store when the PE count or the ownership changed).
- GC: only the newest `keep` checkpoints stay.

A tree is a nest of dicts (walked in sorted-key order), lists, tuples and
NamedTuples, with None as an empty subtree; every other value is a leaf
(a tensor, a numpy array or a scalar). A leaf's path joins its keys,
indices and field names with "##", the paths and order the JAX package's
`jax.tree_util` walk gives, so a checkpoint written by either package
reads under the other. Tensors are written as the numpy arrays they
convert to: k-mer words must be converted to their uint32/uint64 form
first (`words.to_numpy_words`), as `KmerCounter.save` does, so a file
holds exactly what the JAX package writes.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "##"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container node in walk order, or None for a
    leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _leaf_paths(tree, prefix=()) -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf of `tree`, in walk order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(_SEP.join(prefix), tree)]
    out = []
    for key, child in kids:
        out.extend(_leaf_paths(child, prefix + (key,)))
    return out


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of one leaf: later in-place updates of a tensor never
    reach it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu").numpy().copy()
    return np.array(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path: _to_numpy(leaf) for path, leaf in _leaf_paths(tree)}


def _unflatten(template, leaves):
    """`template`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if template is None:
        return None
    if isinstance(template, dict):
        rebuilt = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: rebuilt[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*[_unflatten(getattr(template, f), leaves)
                                for f in template._fields])
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(c, leaves) for c in template)
    return next(leaves)


def save(ckpt_dir: str, step: int, trees: Dict[str, Any],
         extra: Optional[Dict[str, Any]] = None, keep: int = 3, *,
         fault=None) -> str:
    """Write named trees, e.g. {'store': {'keys': ..., 'counts': ...}}, as
    checkpoint `step`; returns its directory.

    `fault`: an armed `resilience.FaultPlan(site='ckpt_write')` tears the
    write after `fault.fail_after` complete leaves (half the leaf's bytes
    land in the staged `.tmp` directory) and raises `InjectedFault`
    before the rename."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "trees": {}, "extra": extra or {}}
    files_written = 0
    for name, tree in trees.items():
        flat = _flatten(tree)
        tdir = os.path.join(tmp, name)
        os.makedirs(tdir)
        manifest["trees"][name] = {
            k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in flat.items()}
        for k, v in flat.items():
            path = os.path.join(tdir, k.replace("/", "_") + ".npy")
            if fault is not None and files_written == fault.fail_after:
                from repro_torch.core.resilience import InjectedFault
                with open(path, "wb") as f:   # torn write: half the bytes
                    f.write(v.tobytes()[:max(1, v.nbytes // 2)])
                raise InjectedFault(
                    f"injected checkpoint-write failure after "
                    f"{files_written} leaves (FaultPlan site='ckpt_write')")
            np.save(path, v, allow_pickle=False)
            files_written += 1
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


class AsyncSaver:
    """Copy to host on the call, write on a thread; one save in flight (a
    newer save waits for the previous write).

    A background write that fails is held and raised again from the next
    `wait()` or `save()`, once, so a caller never relies on a checkpoint
    that was not completed. The disk still holds the previous complete
    checkpoint (the rename is atomic)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, trees: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> None:
        host_trees = {n: _unflatten(t, iter(_flatten(t).values()))
                      for n, t in trees.items()}     # host snapshot now
        self.wait()   # also raises the previous write's failure, if any

        def _run():
            try:
                save(self.ckpt_dir, step, host_trees, extra, self.keep)
            except BaseException as e:   # held for the next wait()/save()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step under `ckpt_dir` (staged `.tmp` directories
    do not count), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, templates: Dict[str, Any]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Named trees of checkpoint `step` in the structure of `templates`
    (their leaves only fix the structure), as host numpy arrays; and the
    manifest's `extra`."""
    cdir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(cdir, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, template in templates.items():
        saved = list(manifest["trees"][name])
        paths = [p for p, _ in _leaf_paths(template)]
        if len(saved) != len(paths):
            raise ValueError(
                f"checkpoint tree {name!r} has {len(saved)} leaves; "
                f"template has {len(paths)} (topology changed?)")
        arrays = [np.load(os.path.join(cdir, name,
                                       p.replace("/", "_") + ".npy"))
                  for p in paths]
        out[name] = _unflatten(template, iter(arrays))
    return out, manifest["extra"]


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
