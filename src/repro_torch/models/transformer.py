"""Decoder LM assembly: the `attn` stack (dense or MoE) and the recurrent
and hybrid block patterns (`rwkv6`, `rglru` with `attn_local`); the
forward over the serving caches, and the training forward without caches
for the attention stacks.

The counterpart of ``repro/models/transformer.py``.  The reference stacks
layer params per pattern position and scans over them under
`jax.checkpoint`; the port keeps a plain list of per-layer dicts
(``params["layers"]``; layer i is of kind ``block_pattern[i % P]``),
loops, and with `ModelConfig.remat` wraps each layer of the training
forward in `torch.utils.checkpoint`.  `repro_torch.convert` unstacks a
reference params tree into this layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import griffin as GR
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as RW
from repro_torch.quant.policy import NONE, PositPolicy

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # capacity/dispatch group: training drops overflow per `group_size`
    # tokens, in arrival order (models/moe.py)
    group_size: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A decoder with RMSNorm, RoPE and a tied embedding table (the
    reference's defaults).  Layer i is of kind ``block_pattern[i % P]``:
    "attn", "attn_local" (sliding `window`), "rwkv6" (heads of
    `rwkv_head_dim`) or "rglru"; `moe` replaces each MLP by a
    Mixture-of-Experts block; `embed_scale` multiplies the embeddings by
    sqrt(d_model) (gemma)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    act: str = "swiglu"               # or "geglu"
    rope_theta: float = 10000.0
    block_pattern: tuple[str, ...] = ("attn",)
    window: int | None = None         # for "attn_local"
    moe: MoEConfig | None = None
    embed_scale: bool = False
    rwkv_head_dim: int = 64
    policy: PositPolicy = NONE
    remat: bool = True                # recompute each layer in the backward

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def kind(self, i: int) -> str:
        """Block kind of layer i."""
        return self.block_pattern[i % len(self.block_pattern)]

    def param_count(self) -> int:
        """Parameters of every layer (by kind) and the tied embedding."""
        d, hd, ff = self.d_model, self.hd, self.d_ff
        if self.moe:
            E = self.moe.n_experts
            mlp = d * E + E * 3 * d * ff
        else:
            mlp = 3 * d * ff
        per_kind = {
            "attn": d * hd * (2 * self.n_heads + 2 * self.n_kv) + mlp,
            # time mix: 5 projections, mixes, w0, the decay LoRA, u, ln_x;
            # channel mix: 3 projections and 2 mixes
            "rwkv6": (6 * d * d + 2 * d * ff + 2 * d * RW.DECAY_LORA
                      + 10 * d),
            # 5 projections, conv taps and bias, lam; the MLP
            "rglru": 5 * d * d + 6 * d + mlp,
        }
        per_kind["attn_local"] = per_kind["attn"]
        layers = sum(per_kind[self.kind(i)] + 2 * d
                     for i in range(self.n_layers))
        return layers + self.vocab * d + d


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Params:
    """The port's own seeded init, with the reference's distributions:
    N(0, 1/fan_in) linears, N(0, 1/d) embedding, unit norm scales,
    `moe.init_moe`'s expert tables and the recurrent blocks' own inits."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d = cfg.d_model
    layers = []
    for i in range(cfg.n_layers):
        kind = cfg.kind(i)
        layer = {"ln1": B.init_rmsnorm(d, dev), "ln2": B.init_rmsnorm(d, dev)}
        if kind == "rwkv6":
            layer["tmix"] = RW.init_rwkv6(gen, d, cfg.rwkv_head_dim)
            layer["cmix"] = RW.init_rwkv6_channel_mix(gen, d, cfg.d_ff)
            layers.append(layer)
            continue
        if kind in ("attn", "attn_local"):
            layer["attn"] = B.init_attention(gen, d, cfg.n_heads, cfg.n_kv,
                                             cfg.hd)
        elif kind == "rglru":
            layer["rec"] = GR.init_rglru_block(gen, d)
        else:
            raise ValueError(f"block kind {kind!r}")
        if cfg.moe:
            layer["moe"] = MOE.init_moe(gen, d, cfg.d_ff, cfg.moe.n_experts,
                                        cfg.act)
        else:
            layer["mlp"] = B.init_mlp(gen, d, cfg.d_ff)
        layers.append(layer)
    return {
        "embed": B.init_embedding(gen, cfg.vocab, d),
        "ln_f": B.init_rmsnorm(d, dev),
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


# ---- serving caches (paged KV pools and state pools) ---------------------
def init_paged_pages(cfg: ModelConfig, num_pages: int, page_size: int, *,
                     max_seqs: int = 0, device="cuda"):
    """One pool per layer, {"layers": [...]}, by the layer's backend: a
    paged (posit) KV pool {"k_pages", "v_pages"} for attn/attn_local, a
    state pool of max_seqs slots for rwkv6/rglru (serving/backends.py)."""
    from repro_torch.serving.backends import backend_for
    dev = resolve_device(device)
    return {"layers": [backend_for(cfg.kind(i), cfg).init_layer(
        cfg, num_pages, page_size, max_seqs, dev)
        for i in range(cfg.n_layers)]}


def assemble_paged_caches(pages, page_table, seq_lens, num_new):
    """Pools + this step's scheduler inputs -> forward()-ready caches; KV
    pools take the page table, state pools only seq_lens/num_new."""
    from repro_torch.serving.paged_kv import assemble_layer_cache

    def one(p):
        if "k_pages" in p:
            return assemble_layer_cache(p, page_table, seq_lens, num_new)
        return {**p, "seq_lens": seq_lens, "num_new": num_new}
    return {"layers": [one(p) for p in pages["layers"]]}


def extract_paged_pages(caches):
    """Inverse of assemble_paged_caches: keep only the pools."""
    from repro_torch.serving.paged_kv import extract_layer_pages

    def one(c):
        if "k_pages" in c:
            return extract_layer_pages(c)
        return {k: v for k, v in c.items()
                if k not in ("seq_lens", "num_new")}
    return {"layers": [one(c) for c in caches["layers"]]}


def _ffn(x, p, cfg: ModelConfig, cache):
    """The second half of an attention or rglru layer: x + MLP (or MoE) of
    its norm -> (x, the MoE aux loss or None)."""
    if not cfg.moe:
        return x + B.mlp_block(B.rms_norm(x, p["ln2"]), p["mlp"],
                               act=cfg.act, policy=cfg.policy), None
    # serving never drops: a per-group capacity would couple a token's
    # output to the other requests sharing its step
    h, aux = MOE.moe_block(
        B.rms_norm(x, p["ln2"]), p["moe"], n_experts=cfg.moe.n_experts,
        top_k=cfg.moe.top_k, act=cfg.act, policy=cfg.policy,
        capacity_factor=(None if cache is not None
                         else cfg.moe.capacity_factor),
        group_size=cfg.moe.group_size)
    return x + h, aux


def _rwkv6_layer(x, p, cfg: ModelConfig, cache):
    from repro_torch.serving import backends as SB
    sl, nn = cache["seq_lens"], cache["num_new"]
    S0 = SB.zero_fresh(cache["wkv"], sl)
    tsh = SB.zero_fresh(cache["tshift"], sl)
    csh = SB.zero_fresh(cache["cshift"], sl)
    h, (S_fin, t_last) = RW.rwkv6_time_mix_serving(
        B.rms_norm(x, p["ln1"]), p["tmix"], head_dim=cfg.rwkv_head_dim,
        policy=cfg.policy, state=(S0, tsh), num_new=nn)
    x = x + h
    h, c_last = RW.rwkv6_channel_mix_serving(
        B.rms_norm(x, p["ln2"]), p["cmix"], policy=cfg.policy, last_x=csh,
        num_new=nn)
    new_cache = {"wkv": S_fin,
                 "tshift": SB.store_state(cache["tshift"], t_last, nn),
                 "cshift": SB.store_state(cache["cshift"], c_last, nn),
                 "seq_lens": sl, "num_new": nn}
    return x + h, new_cache, None


def _rglru_layer(x, p, cfg: ModelConfig, cache):
    from repro_torch.serving import backends as SB
    sl, nn = cache["seq_lens"], cache["num_new"]
    h0 = SB.zero_fresh(cache["h"], sl)
    cv = SB.zero_fresh(cache["conv"], sl)
    h, (h_fin, conv_last) = GR.rglru_block_serving(
        B.rms_norm(x, p["ln1"]), p["rec"], policy=cfg.policy,
        state=(h0, cv), num_new=nn)
    new_cache = {"h": h_fin,
                 "conv": SB.store_state(cache["conv"], conv_last, nn),
                 "seq_lens": sl, "num_new": nn}
    x, aux = _ffn(x + h, p, cfg, cache)
    return x, new_cache, aux


def _layer(x, p, cfg: ModelConfig, kind: str, positions, cache):
    """-> (x, new cache, the layer's MoE aux loss or None)."""
    if kind == "rwkv6":
        return _rwkv6_layer(x, p, cfg, cache)
    if kind == "rglru":
        return _rglru_layer(x, p, cfg, cache)
    h, nc = B.attention_block(
        B.rms_norm(x, p["ln1"]), p["attn"], n_heads=cfg.n_heads,
        n_kv=cfg.n_kv, head_dim=cfg.hd, positions=positions,
        policy=cfg.policy, rope_theta=cfg.rope_theta,
        window=cfg.window if kind == "attn_local" else None, kv_cache=cache)
    x, aux = _ffn(x + h, p, cfg, cache)
    return x, nc, aux


def forward(params: Params, cfg: ModelConfig, *, tokens: torch.Tensor,
            caches=None, positions=None, return_hidden: bool = False):
    """Returns (logits [B, S, vocab] f32, aux_loss, new_caches); aux_loss
    is the MoE layers' summed load-balancing loss (0 for a dense model).

    tokens [B, S] int.  caches: from assemble_paged_caches (serving), or
    None (training: each sequence attends over itself from position 0;
    new_caches is None).  positions default to each sequence's cache
    length (0 without caches) plus arange(S).  return_hidden: return the
    final normalized hidden states [B, S, d] instead of logits (the
    chunked-loss training path computes the LM head per chunk).
    """
    if cfg.act not in ("swiglu", "geglu"):
        raise NotImplementedError(f"act {cfg.act!r} is not ported")
    kinds = [cfg.kind(i) for i in range(len(params["layers"]))]
    if caches is None and any(k in ("rwkv6", "rglru") for k in kinds):
        raise NotImplementedError(
            "recurrent training (the forward without caches: the chunked "
            "WKV and the associative RG-LRU scan) is not ported yet "
            "(ROADMAP A.14)")
    pol = cfg.policy
    x = B.embed(tokens, params["embed"], pol).to(torch.float32)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    Bsz, S = tokens.shape
    layers = (caches["layers"] if caches is not None
              else [None] * len(params["layers"]))
    if positions is None:
        off = (layers[0]["seq_lens"][:, None] if caches is not None
               else torch.zeros((Bsz, 1), dtype=torch.int32,
                                device=x.device))
        positions = off + torch.arange(S, device=x.device)[None, :]

    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_layers = []
    for p, kind, cache in zip(params["layers"], kinds, layers):
        if remat:
            # keep the layer's input only; the backward recomputes the rest
            x, nc, a = checkpoint(_layer, x, p, cfg, kind, positions, cache,
                                  use_reentrant=False)
        else:
            x, nc, a = _layer(x, p, cfg, kind, positions, cache)
        if a is not None:
            aux = aux + a
        new_layers.append(nc)

    x = B.rms_norm(x, params["ln_f"])
    new_caches = {"layers": new_layers} if caches is not None else None
    if return_hidden:
        return x, aux, new_caches
    return B.unembed(x, params["embed"], pol), aux, new_caches
