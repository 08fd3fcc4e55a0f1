"""Decoder LM assembly for the `attn` block pattern, served over a paged
KV cache.

The counterpart of ``repro/models/transformer.py``.  The reference stacks
layer params per pattern position and scans over them; the port keeps a
plain list of per-layer dicts (``params["layers"]``) and loops.
`repro_torch.convert` unstacks a reference params tree into this layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

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

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


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


def forward(params: Params, cfg: ModelConfig, *, tokens: torch.Tensor,
            caches, positions=None):
    """Returns (logits [B, S, vocab] f32, aux_loss, new_caches).

    tokens [B, S] int; caches from assemble_paged_caches.  positions
    default to each sequence's cache length plus arange(S).
    """
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act {cfg.act!r} is not ported")
    pol = cfg.policy
    x = B.embed(tokens, params["embed"], pol).to(torch.float32)
    Bsz, S = tokens.shape
    layers = caches["layers"]
    if positions is None:
        sl = layers[0]["seq_lens"]
        positions = sl[:, None] + torch.arange(S, device=x.device)[None, :]

    new_layers = []
    for p, cache in zip(params["layers"], layers):
        h, nc = B.attention_block(
            B.rms_norm(x, p["ln1"]), p["attn"], n_heads=cfg.n_heads,
            n_kv=cfg.n_kv, head_dim=cfg.hd, positions=positions, policy=pol,
            rope_theta=cfg.rope_theta, kv_cache=cache)
        x = x + h
        x = x + B.mlp_block(B.rms_norm(x, p["ln2"]), p["mlp"], act=cfg.act,
                            policy=pol)
        new_layers.append(nc)

    x = B.rms_norm(x, params["ln_f"])
    logits = B.unembed(x, params["embed"], pol)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, {"layers": new_layers}
