"""Reference params tree (as numpy) -> the port's params.

The JAX package's params nest dicts and tuples; its layer params are
stacked per block-pattern position (a leading reps axis, scanned over),
followed by the `rem` remainder layers.  This converter takes that tree
with every leaf already turned into numpy by the caller:

  * plain leaves are ``np.ndarray``;
  * posit leaves are ``(bits ndarray, n, es)``;

and returns ``{"embed", "ln_f", "layers": [per-layer dict, ...]}`` with
torch tensors and `PositArray`s on `device`.  Layer
``r * P + pos`` of the stack is rep r of pattern position pos.  It never
sees a JAX object.  Any tree of the params' structure converts the same
way: a gradient tree, or the AdamW moments ``m`` and ``v``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.array import PositArray
from repro_torch.core.types import PositConfig
from repro_torch.device import resolve_device


def _is_posit_leaf(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 3
            and isinstance(x[0], np.ndarray) and isinstance(x[1], int))


def _map(node, fn):
    if _is_posit_leaf(node) or isinstance(node, np.ndarray):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map(v, fn) for v in node)
    raise TypeError(f"unexpected leaf {type(node)!r} in the params tree")


def _leaf(dev):
    def to_torch(x):
        if _is_posit_leaf(x):
            bits, n, es = x
            return PositArray(torch.from_numpy(np.array(bits))
                              .to(dev), PositConfig(n, es))
        return torch.from_numpy(np.array(x)).to(dev)
    return to_torch


def _rep(r):
    def pick(x):
        if _is_posit_leaf(x):
            return (x[0][r], x[1], x[2])
        return x[r]
    return pick


def from_repro(tree: dict, *, device="cuda") -> dict:
    """Convert a numpy-leaved reference params-shaped tree (params, their
    gradients or AdamW moments; see module doc)."""
    dev = resolve_device(device)
    to_torch = _leaf(dev)
    scanned = tree.get("scanned", ())
    layers = []
    if scanned:
        first = scanned[0]["ln1"]["scale"]
        reps = (first[0] if _is_posit_leaf(first) else first).shape[0]
        for r in range(reps):
            for pos_params in scanned:
                layers.append(_map(_map(pos_params, _rep(r)), to_torch))
    layers.extend(_map(p, to_torch) for p in tree.get("rem", ()))
    if "unembed" in tree:
        raise NotImplementedError("untied unembedding is not ported")
    return {"embed": _map(tree["embed"], to_torch),
            "ln_f": _map(tree["ln_f"], to_torch),
            "layers": layers}
