"""Loss and train step.

The counterpart of ``repro/training/train_step.py``: next-token
cross-entropy with the LM head evaluated per 512-row sequence chunk (each
chunk recomputed in the backward, so the [B, S, vocab] logits never exist
at full length), gradient accumulation over microbatches, and the AdamW
update.  Gradients come from torch.autograd over the port's model, whose
GEMMs and attention run the posit GEMM and flash kernels forward and
backward.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.transformer import ModelConfig, decay_mask, forward
from repro_torch.optim import adamw

AUX_WEIGHT = 0.01
LM_HEAD_CHUNK = 512


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log p(label) without a log_softmax: logsumexp minus the label's
    logit, picked by an iota compare (a masked sum, as the reference)."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    iota = torch.arange(lg.shape[-1], device=lg.device)
    picked = torch.where(iota == labels[..., None].long(), lg, 0.0).sum(-1)
    return lse - picked


def _chunk_nll(h, lab, params, cfg: ModelConfig):
    return _token_nll(B.unembed(h, params["embed"], cfg.policy), lab).sum()


def _chunked_lm_head_nll(hidden, labels, params, cfg: ModelConfig):
    """Mean NLL with the LM head evaluated per sequence chunk, each chunk
    under checkpoint (recomputed in the backward)."""
    Bsz, S, _ = hidden.shape
    c = min(LM_HEAD_CHUNK, S)
    total = 0.0
    for s0 in range(0, S, c):
        h, lab = hidden[:, s0:s0 + c], labels[:, s0:s0 + c]
        if torch.is_grad_enabled():
            nll = checkpoint(_chunk_nll, h, lab, params, cfg,
                             use_reentrant=False)
        else:
            nll = _chunk_nll(h, lab, params, cfg)
        total = total + nll
    return total / (Bsz * S)


def lm_loss(params, cfg: ModelConfig, batch):
    """(loss, metrics) of a batch {"tokens": [B, S+1] int}: inputs are
    tokens[:, :-1], labels tokens[:, 1:]."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    hidden, aux, _ = forward(params, cfg, tokens=inputs, return_hidden=True)
    nll = _chunked_lm_head_nll(hidden, labels, params, cfg)
    return nll + AUX_WEIGHT * aux, {"nll": nll.detach(),
                                     "aux": aux.detach()}


def _value_and_grad(params, cfg: ModelConfig, batch):
    flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss, metrics = lm_loss(tree.unflatten(tree.structure(params), flat),
                            cfg, batch)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), metrics, tree.unflatten(tree.structure(params),
                                                  list(grads))


def _compute_grads(params, batch, cfg: ModelConfig, accum_steps: int):
    """(loss, metrics, grads) for one batch; accum_steps > 1 averages the
    gradients of that many equal microbatches, taken in order."""
    if accum_steps == 1:
        return _value_and_grad(params, cfg, batch)
    rows = batch["tokens"].shape[0]
    if rows % accum_steps:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{accum_steps} microbatches")
    mb = rows // accum_steps
    g_acc = tree.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
    l_acc = torch.zeros((), dtype=torch.float32,
                        device=batch["tokens"].device)
    for i in range(accum_steps):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, _, g = _value_and_grad(params, cfg, micro)
        g_acc = tree.map_tree(torch.add, g_acc, g)
        l_acc = l_acc + loss
    inv = 1.0 / accum_steps
    return l_acc * inv, {}, tree.map_tree(lambda g: g * inv, g_acc)


def train_step(params, opt_state, batch, cfg: ModelConfig,
               opt_cfg: adamw.OptConfig, accum_steps: int = 1):
    """One optimization step: (new params, new opt state, metrics)."""
    loss, metrics, grads = _compute_grads(params, batch, cfg, accum_steps)
    params, opt_state, opt_metrics = adamw.apply_updates(
        params, grads, opt_state, opt_cfg, decay=decay_mask(params))
    metrics = dict(metrics, loss=loss, **opt_metrics)
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig, mesh=None,
                    *, accum_steps: int = 1, chaos_nar: bool = False,
                    device="cuda"):
    """`step(params, opt_state, batch)` on `device` (the batch is moved
    there).  The sharded step over a device mesh and the NaR chaos hook
    are not ported yet."""
    if mesh is not None:
        raise NotImplementedError("make_train_step: the sharded (mesh) "
                                  "train step is not ported yet")
    if chaos_nar:
        raise NotImplementedError("make_train_step: chaos NaR injection is "
                                  "not ported yet")
    dev = resolve_device(device)

    def step(params, opt_state, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        return train_step(params, opt_state, batch, cfg, opt_cfg,
                          accum_steps)

    return step
