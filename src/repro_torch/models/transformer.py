"""Decoder LM assembly for the `attn` block pattern: the forward over a
paged KV cache (serving) and without caches (training).

The counterpart of ``repro/models/transformer.py``.  The reference stacks
layer params per pattern position and scans over them under
`jax.checkpoint`; the port keeps a plain list of per-layer dicts
(``params["layers"]``), loops, and with `ModelConfig.remat` wraps each
layer of the training forward in `torch.utils.checkpoint`.
`repro_torch.convert` unstacks a reference params tree into this layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.quant.policy import NONE, PositPolicy

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A dense decoder: all-`attn` layers, RMSNorm, SwiGLU, RoPE and a
    tied embedding table (the reference's defaults)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    act: str = "swiglu"
    rope_theta: float = 10000.0
    policy: PositPolicy = NONE
    remat: bool = True                # recompute each layer in the backward

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Parameters of the tied-embedding SwiGLU decoder."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (2 * self.n_heads + 2 * self.n_kv)
        per_layer = attn + 3 * d * self.d_ff + 2 * d
        return self.n_layers * per_layer + self.vocab * d + d


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Params:
    """The port's own seeded init, with the reference's distributions:
    N(0, 1/fan_in) linears, N(0, 1/d) embedding, unit norm scales."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": B.init_rmsnorm(cfg.d_model, dev),
            "ln2": B.init_rmsnorm(cfg.d_model, dev),
            "attn": B.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                     cfg.hd),
            "mlp": B.init_mlp(gen, cfg.d_model, cfg.d_ff),
        })
    return {
        "embed": B.init_embedding(gen, cfg.vocab, cfg.d_model),
        "ln_f": B.init_rmsnorm(cfg.d_model, dev),
        "layers": layers,
    }


def decay_mask(params: Params) -> Params:
    """Which leaves take AdamW's weight decay, as in the reference: it
    decays every leaf with ndim >= 2 of its own tree, where each per-layer
    leaf is stacked over the layers (one axis more than here).  So every
    per-layer leaf is decayed, the RMSNorm scales included, and of the
    rest the leaves with ndim >= 2 (the embedding table, not ln_f)."""
    from repro_torch import tree
    mask = tree.map_tree(lambda p: p.ndim >= 2, params)
    mask["layers"] = tree.map_tree(lambda p: True, params["layers"])
    return mask


# ---- paged caches --------------------------------------------------------
def init_paged_pages(cfg: ModelConfig, num_pages: int, page_size: int, *,
                     device="cuda"):
    """One page pool per layer: {"layers": [{"k_pages", "v_pages"}, ...]}."""
    from repro_torch.serving.paged_kv import init_layer_pages
    dev = resolve_device(device)
    return {"layers": [init_layer_pages(num_pages, cfg.n_kv, page_size,
                                        cfg.hd, cfg.policy.kv_cache, dev)
                       for _ in range(cfg.n_layers)]}


def assemble_paged_caches(pages, page_table, seq_lens, num_new):
    """Pools + this step's scheduler inputs -> forward()-ready caches."""
    from repro_torch.serving.paged_kv import assemble_layer_cache
    return {"layers": [assemble_layer_cache(p, page_table, seq_lens, num_new)
                       for p in pages["layers"]]}


def extract_paged_pages(caches):
    """Inverse of assemble_paged_caches: keep only the pools."""
    from repro_torch.serving.paged_kv import extract_layer_pages
    return {"layers": [extract_layer_pages(c) for c in caches["layers"]]}


def _layer(x, p, cfg: ModelConfig, positions, cache):
    h, nc = B.attention_block(
        B.rms_norm(x, p["ln1"]), p["attn"], n_heads=cfg.n_heads,
        n_kv=cfg.n_kv, head_dim=cfg.hd, positions=positions,
        policy=cfg.policy, rope_theta=cfg.rope_theta, kv_cache=cache)
    x = x + h
    x = x + B.mlp_block(B.rms_norm(x, p["ln2"]), p["mlp"], act=cfg.act,
                        policy=cfg.policy)
    return x, nc


def forward(params: Params, cfg: ModelConfig, *, tokens: torch.Tensor,
            caches=None, positions=None, return_hidden: bool = False):
    """Returns (logits [B, S, vocab] f32, aux_loss, new_caches).

    tokens [B, S] int.  caches: from assemble_paged_caches (serving), or
    None (training: each sequence attends over itself from position 0;
    new_caches is None).  positions default to each sequence's cache
    length (0 without caches) plus arange(S).  return_hidden: return the
    final normalized hidden states [B, S, d] instead of logits (the
    chunked-loss training path computes the LM head per chunk).
    """
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act {cfg.act!r} is not ported")
    pol = cfg.policy
    x = B.embed(tokens, params["embed"], pol).to(torch.float32)
    Bsz, S = tokens.shape
    layers = (caches["layers"] if caches is not None
              else [None] * len(params["layers"]))
    if positions is None:
        off = (layers[0]["seq_lens"][:, None] if caches is not None
               else torch.zeros((Bsz, 1), dtype=torch.int32,
                                device=x.device))
        positions = off + torch.arange(S, device=x.device)[None, :]

    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    new_layers = []
    for p, cache in zip(params["layers"], layers):
        if remat:
            # keep the layer's input only; the backward recomputes the rest
            x, nc = checkpoint(_layer, x, p, cfg, positions, cache,
                               use_reentrant=False)
        else:
            x, nc = _layer(x, p, cfg, positions, cache)
        new_layers.append(nc)

    x = B.rms_norm(x, params["ln_f"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = {"layers": new_layers} if caches is not None else None
    if return_hidden:
        return x, aux, new_caches
    return B.unembed(x, params["embed"], pol), aux, new_caches
