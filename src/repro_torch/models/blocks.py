"""Transformer building blocks on torch tensors (params are nested dicts).

The counterpart of ``repro/models/blocks.py`` for the serving path:
`rms_norm`, `linear`, `rope`, the paged branch of `attention_block`, the
SwiGLU `mlp_block`, `embed` and `unembed`.  The plain attention (the
mirror of the reference's ``_blockwise_jnp``) lives beside the other
plain versions, in `kernels.ref.blockwise_attention_ref`.  Activations
are float32.
Posit weights arrive as `PositArray` (from `quant.ptq`) and go through the
posit GEMM; posit KV pages are decoded inside the attention kernels.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.array import PositArray
from repro_torch.kernels import ops
from repro_torch.quant.policy import PositPolicy, posit_cast

Params = dict[str, Any]


# ---- initializers (the reference's distributions, a torch generator) -----
def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def init_rmsnorm(d: int, device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def init_linear(gen, d_in: int, d_out: int) -> Params:
    return {"w": _normal(gen, (d_in, d_out), d_in ** -0.5)}


def init_attention(gen, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int) -> Params:
    return {
        "wq": init_linear(gen, d_model, n_heads * head_dim),
        "wk": init_linear(gen, d_model, n_kv * head_dim),
        "wv": init_linear(gen, d_model, n_kv * head_dim),
        "wo": init_linear(gen, n_heads * head_dim, d_model),
    }


def init_mlp(gen, d_model: int, d_ff: int) -> Params:
    return {"w_up": init_linear(gen, d_model, d_ff),
            "w_down": init_linear(gen, d_ff, d_model),
            "w_gate": init_linear(gen, d_model, d_ff)}


def init_embedding(gen, vocab: int, d_model: int) -> Params:
    return {"table": _normal(gen, (vocab, d_model), d_model ** -0.5)}


# ---- layers ---------------------------------------------------------------
def rms_norm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    h = x.to(torch.float32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * p["scale"]).to(x.dtype)


def linear(x: torch.Tensor, p: Params,
           policy: PositPolicy | None = None) -> torch.Tensor:
    w = p["w"]
    if isinstance(w, PositArray):
        return ops.pw_matmul(x, w).to(x.dtype)
    if policy is not None and policy.weights is not None:
        w = posit_cast(w, policy.weights)
    return torch.matmul(x, w)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x [..., S, D] with D even; positions [..., S] (int)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_block(x, p: Params, *, n_heads: int, n_kv: int, head_dim: int,
                    positions, policy: PositPolicy, causal: bool = True,
                    window=None, rope_theta: float = 10000.0, kv_cache,
                    softcap=None):
    """Returns (out, new_kv_cache) over a paged cache dict (see
    serving.paged_kv): append this step's K/V, then attend."""
    from repro_torch.serving.paged_kv import (is_paged, paged_append_kv,
                                              paged_attention)
    if not is_paged(kv_cache):
        raise NotImplementedError("attention_block serves through a paged "
                                  "cache; the dense cache is not ported")
    B, S, _ = x.shape
    q = linear(x, p["wq"], policy).reshape(B, S, n_heads, head_dim)
    k = linear(x, p["wk"], policy).reshape(B, S, n_kv, head_dim)
    v = linear(x, p["wv"], policy).reshape(B, S, n_kv, head_dim)

    q = rope(q.transpose(1, 2), positions[:, None, :], rope_theta)
    k = rope(k.transpose(1, 2), positions[:, None, :], rope_theta)
    v = v.transpose(1, 2)

    q_offset = kv_cache["seq_lens"]
    new_cache = paged_append_kv(kv_cache, k, v)
    out = paged_attention(q, new_cache, n_kv=n_kv, causal=causal,
                          q_offset=q_offset, window=window, softcap=softcap)
    out = out.transpose(1, 2).reshape(B, S, n_heads * head_dim)
    return linear(out, p["wo"], policy), new_cache


def mlp_block(x, p: Params, *, act: str, policy: PositPolicy):
    if act != "swiglu":
        raise NotImplementedError(f"mlp act {act!r} is not ported")
    up = linear(x, p["w_up"], policy)
    h = torch.nn.functional.silu(linear(x, p["w_gate"], policy)) * up
    return linear(h, p["w_down"], policy)


def embed(tokens: torch.Tensor, p: Params, policy: PositPolicy):
    t = p["table"]
    if isinstance(t, PositArray):
        return t[tokens.long()].to_f32()       # gather bits, then decode
    if policy is not None and policy.weights is not None:
        t = posit_cast(t, policy.weights)
    return t[tokens.long()]


def unembed(h: torch.Tensor, p: Params, policy: PositPolicy | None):
    """h [..., d] @ tied table [V, d].T -> logits [..., V]; a posit table
    streams through the GEMM with transpose_b (no decoded copy)."""
    t = p["table"]
    if isinstance(t, PositArray):
        return ops.pw_matmul(h, t, transpose_b=True)
    if policy is not None and policy.weights is not None:
        t = posit_cast(t, policy.weights)
    return torch.matmul(h.to(torch.float32), t.T)
