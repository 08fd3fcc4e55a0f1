"""AdamW with global-norm clipping and the non-finite-gradient skip.

The counterpart of ``repro/optim/adamw.py``: the same warmup-cosine
schedule, bias-corrected moments, decoupled weight decay on leaves with
ndim >= 2 (or on the leaves a `decay` mask names), and the NaR guard (a
non-finite global gradient norm skips the whole update and counts it in
``nar_skips``).  Every step is a pure
function of (params, grads, state) on torch tensors; the step counter and
the skip count are int32 tensors on the params' device, so the update
never waits on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # "bfloat16" halves the moments


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    """Learning rate at `step` (int or int tensor): linear warmup, then a
    cosine from lr_peak down to lr_min_ratio * lr_peak, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * (step + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def init_state(params, cfg: OptConfig) -> dict[str, Any]:
    mdt = getattr(torch, cfg.moment_dtype)
    dev = tree.leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree.map_tree(zeros, params),
        "v": tree.map_tree(zeros, params),
        # lifetime count of updates skipped by the non-finite-gradient
        # guard; part of the state, so a resume keeps it
        "nar_skips": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.leaves(grads)))


def apply_updates(params, grads, state, cfg: OptConfig, decay=None):
    """Returns (new_params, new_state, metrics).

    decay: a tree of bools beside params naming the leaves that take weight
    decay; None decays the leaves with ndim >= 2 (the reference's rule on
    its own tree: see `models.transformer.decay_mask`).

    A non-finite global norm (a NaN or Inf anywhere in the gradients, what
    a posit NaR decodes to) skips the update: params, moments, step and
    the schedule stay as they were and state["nar_skips"] grows by one.
    The guard is a per-leaf select, so an update that is not skipped is
    bit-identical to unguarded AdamW.
    """
    gn = global_norm(grads)
    ok = torch.isfinite(gn)
    step = state["step"] + ok.to(torch.int32)
    # a NaN norm would make the scale NaN even in the branch not taken
    scale = torch.where(ok, torch.clamp(cfg.clip_norm / (gn + 1e-9),
                                        max=1.0), 0.0)
    lr = lr_at(step, cfg)
    mdt = getattr(torch, cfg.moment_dtype)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v, dec):
        g = torch.where(ok, g.to(torch.float32) * scale, 0.0)
        m32 = m.to(torch.float32) * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.to(torch.float32) * cfg.b2 + torch.square(g) * (1 - cfg.b2)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        if dec:
            delta = delta + cfg.weight_decay * pf
        newp = pf - lr * delta
        return (torch.where(ok, newp.to(p.dtype), p),
                torch.where(ok, m32.to(mdt), m),
                torch.where(ok, v32.to(mdt), v))

    flat_p = tree.leaves(params)
    flat_d = ([p.ndim >= 2 for p in flat_p] if decay is None
              else tree.leaves(decay))
    out = [upd(*a) for a in zip(flat_p, tree.leaves(grads),
                                tree.leaves(state["m"]),
                                tree.leaves(state["v"]), flat_d)]
    struct = tree.structure(params)
    new_p, new_m, new_v = (tree.unflatten(struct, [o[i] for o in out])
                           for i in range(3))
    skips = state["nar_skips"] + (1 - ok.to(torch.int32))
    new_state = {"step": step, "m": new_m, "v": new_v, "nar_skips": skips}
    return new_p, new_state, {"grad_norm": gn, "lr": lr, "nar_skips": skips}
