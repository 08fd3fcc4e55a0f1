"""RWKV-6 "Finch" blocks (arXiv:2404.05892) on the serving path.

The counterpart of ``repro/models/rwkv6.py``: `init_rwkv6`,
`init_rwkv6_channel_mix` and the stateful serving forms
`rwkv6_time_mix_serving` / `rwkv6_channel_mix_serving`.  The WKV
recurrence runs through `ops.wkv_scan` (K12 on the card) with the state
posit-round-tripped after every token under the KV policy; the token
shifts cross chunk boundaries at their round-tripped values (`rt_values`),
so chunked prefill plus decode equals any other chunking.  The chunked
training form (`rwkv6_time_mix` without state) is not ported.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.models.blocks import (_normal, init_linear, linear,
                                       rt_values, select_last)
from repro_torch.quant.policy import PositPolicy
from repro_torch.serving.backends import state_f32

Params = dict[str, Any]

DECAY_LORA = 64


def init_rwkv6(gen: torch.Generator, d_model: int,
               head_dim: int = 64) -> Params:
    """The reference's init: lerp mixes 0.5, base decay -6, N(0, 1/fan_in)
    projections and decay LoRA A, zero LoRA B and bonus u."""
    dev = gen.device
    H = d_model // head_dim
    return {
        "mix": torch.full((5, d_model), 0.5, device=dev),     # r,k,v,w,g
        "wr": init_linear(gen, d_model, d_model),
        "wk": init_linear(gen, d_model, d_model),
        "wv": init_linear(gen, d_model, d_model),
        "wg": init_linear(gen, d_model, d_model),
        "w0": torch.full((d_model,), -6.0, device=dev),
        "w_lora_a": _normal(gen, (d_model, DECAY_LORA), d_model ** -0.5),
        "w_lora_b": torch.zeros((DECAY_LORA, d_model), device=dev),
        "u": torch.zeros((H, head_dim), device=dev),
        "wo": init_linear(gen, d_model, d_model),
        "ln_x": {"scale": torch.ones((d_model,), device=dev)},
    }


def init_rwkv6_channel_mix(gen: torch.Generator, d_model: int,
                           d_ff: int) -> Params:
    return {
        "mix": torch.full((2, d_model), 0.5, device=gen.device),
        "wk": init_linear(gen, d_model, d_ff),
        "wr": init_linear(gen, d_model, d_model),
        "wv": init_linear(gen, d_ff, d_model),
    }


def _shifted(x: torch.Tensor, last_x, pcfg) -> torch.Tensor:
    """x[t - 1] with the carried last token in front, round-tripped."""
    prev = state_f32(last_x)[:, None].to(x.dtype)
    return rt_values(torch.cat([prev, x[:, :-1]], dim=1), pcfg).to(x.dtype)


def rwkv6_time_mix_serving(x, p: Params, *, head_dim: int,
                           policy: PositPolicy, state, num_new=None):
    """x [B, S, d] -> (out [B, S, d], (S_fin, last_x)).

    state = (S0 [B, H, dh, dh], last_x [B, d]): f32 tensors or PositArray
    pool slots; S_fin comes back in S0's representation, last_x as the raw
    f32 values of this chunk's last valid token (the caller re-encodes it
    with backends.store_state).  num_new [B] masks ragged chunks."""
    B, S, d = x.shape
    H = d // head_dim
    pcfg = policy.kv_cache
    S0, last_x = state
    x_prev = _shifted(x, last_x, pcfg)
    mix = p["mix"]
    xr, xk, xv, xw, xg = (x + (x_prev - x) * mix[i] for i in range(5))

    def heads(t):
        return t.reshape(B, S, H, head_dim).transpose(1, 2).contiguous()

    r = heads(linear(xr, p["wr"], policy))
    k = heads(linear(xk, p["wk"], policy))
    v = heads(linear(xv, p["wv"], policy))
    g = linear(xg, p["wg"], policy)

    # data-dependent decay (the Finch contribution): w = exp(-exp(w0 + lora))
    ww = p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = heads(-torch.exp(torch.clamp(ww, -20.0, 10.0).float()))

    y, S_fin = ops.wkv_scan(r.float(), k.float(), v.float(), logw,
                            p["u"].float(), S0, num_new=num_new,
                            cfg_state=pcfg)
    # per-head group norm, the silu(g) gate, the output projection
    y = y.transpose(1, 2).reshape(B, S, H, head_dim).to(x.dtype)
    mu = y.mean(dim=-1, keepdim=True)
    var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(B, S, d)
    y = y * p["ln_x"]["scale"]
    y = y * torch.nn.functional.silu(g)
    out = linear(y, p["wo"], policy)
    return out, (S_fin, select_last(x, num_new).float())


def rwkv6_channel_mix_serving(x, p: Params, *, policy: PositPolicy, last_x,
                              num_new=None):
    """The channel mix with a chunk-invariant token shift (no recurrence);
    the new shift comes back as raw f32 values, as in the time mix."""
    x_prev = _shifted(x, last_x, policy.kv_cache)
    xk = x + (x_prev - x) * p["mix"][0]
    xr = x + (x_prev - x) * p["mix"][1]
    k = torch.square(torch.relu(linear(xk, p["wk"], policy)))
    out = torch.sigmoid(linear(xr, p["wr"], policy)) * linear(
        k, p["wv"], policy)
    return out, select_last(x, num_new).float()
