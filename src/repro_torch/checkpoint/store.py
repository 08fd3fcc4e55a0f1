"""Atomic, manifest-verified checkpointing (numpy-backed).

The counterpart of ``repro/checkpoint/store.py``, with its contract:

  * a save writes ``<dir>/step_<N>.tmp/`` and renames it to
    ``step_<N>/`` only after every leaf and the manifest are fsync'd, so
    a killed writer leaves a .tmp directory that restore ignores;
  * every leaf carries a full-content sha256 in the manifest, and the
    manifest a combined hash over them;
  * `restore_latest` takes the newest valid step and falls back to older
    ones past any corrupt or partial step;
  * the data pipeline is seekable, so params + optimizer state + step is
    the whole training state and a restart is exact.

Leaves are torch tensors, stored as .npy on the host; a restore puts
each leaf back on the device and dtype of the example tree's leaf.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch import tree

_HASH_CHUNK = 1 << 20    # 1 MiB: bounded memory however large the leaf


def _to_numpy(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:          # numpy has no bfloat16: its bits
        t = t.view(torch.int16)
    return t.numpy()


def _leaf_digest(arr: np.ndarray) -> str:
    """Full-content sha256 of one leaf, streamed in chunks."""
    h = hashlib.sha256()
    mv = memoryview(np.ascontiguousarray(arr)).cast("B")
    for off in range(0, len(mv), _HASH_CHUNK):
        h.update(mv[off:off + _HASH_CHUNK])
    return h.hexdigest()


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    """Durable atomic save of the tensor tree `state` as step `step`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(final):        # idempotent: step already published
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = tree.leaves(state)
    manifest = {"step": step, "structure": repr(tree.structure(state)),
                "leaves": []}
    h = hashlib.sha256()
    for i, leaf in enumerate(flat):
        arr = _to_numpy(leaf)
        fn = f"leaf_{i:05d}.npy"
        with open(os.path.join(tmp, fn), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        digest = _leaf_digest(arr)
        h.update(digest.encode())
        manifest["leaves"].append({"file": fn, "dtype": str(arr.dtype),
                                   "shape": list(arr.shape),
                                   "sha256": digest})
    manifest["hash"] = h.hexdigest()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    os.replace(tmp, final)                       # atomic publish
    _fsync_dir(ckpt_dir)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    """Keep the newest `keep` steps that carry a manifest; partial and
    .tmp directories neither count nor get deleted."""
    if keep <= 0:
        return
    valid = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")))
    for d in valid[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _try_load(path: str, example):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = tree.leaves(example)
    if (manifest.get("structure") != repr(tree.structure(example))
            or len(manifest["leaves"]) != len(like)):
        raise IOError(f"tree structure mismatch in {path}")
    out = []
    h = hashlib.sha256()
    for spec, ex in zip(manifest["leaves"], like):
        arr = np.load(os.path.join(path, spec["file"]))
        if str(arr.dtype) != spec["dtype"] or list(arr.shape) != spec["shape"]:
            raise IOError(f"leaf mismatch in {path}: {spec}")
        digest = _leaf_digest(arr)
        if digest != spec["sha256"]:
            raise IOError(f"leaf hash mismatch in {path}: {spec['file']}")
        h.update(digest.encode())
        t = torch.from_numpy(arr)
        if ex.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        if t.dtype != ex.dtype or tuple(t.shape) != tuple(ex.shape):
            raise IOError(f"leaf {spec['file']} in {path} does not match "
                          f"the example's {ex.dtype} {tuple(ex.shape)}")
        out.append(t.to(ex.device))
    if h.hexdigest() != manifest["hash"]:
        raise IOError(f"hash mismatch in {path}")
    return manifest["step"], tree.unflatten(tree.structure(example), out)


def restore_latest(ckpt_dir: str, example):
    """(step, tree) from the newest valid checkpoint, or (None, None)."""
    if not os.path.isdir(ckpt_dir):
        return None, None
    steps = sorted((d for d in os.listdir(ckpt_dir)
                    if d.startswith("step_") and not d.endswith(".tmp")),
                   reverse=True)
    for d in steps:
        try:
            return _try_load(os.path.join(ckpt_dir, d), example)
        except Exception as e:  # corrupt or partial: fall back to older
            print(f"[checkpoint] skipping {d}: {e}")
    return None, None
