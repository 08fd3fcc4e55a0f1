"""Griffin / RecurrentGemma recurrent block (arXiv:2402.19427) on the
serving path.

The counterpart of ``repro/models/griffin.py``: `init_rglru_block` and
`rglru_block_serving`, the block (linear -> causal conv -> RG-LRU) times
gelu(linear) -> out, with the diagonal recurrence h_t = rt(a_t h + b_t)
through `ops.rglru_scan` (K13 on the card).  The conv tail crosses chunk
boundaries at its round-tripped values (`rt_values`).  The associative-
scan training form (`rglru_block` without state) is not ported.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.models.blocks import (_normal, gelu, init_linear, linear,
                                       rt_values)
from repro_torch.quant.policy import PositPolicy
from repro_torch.serving.backends import CONV_WIDTH, state_f32

Params = dict[str, Any]

LRU_C = 8.0


def init_rglru_block(gen: torch.Generator, d_model: int,
                     d_rnn: int | None = None) -> Params:
    """The reference's init: N(0, 1/fan_in) projections, conv taps
    N(0, 0.01), Lambda spread over linspace(2, 6) so a = sigmoid(lam)^c
    lies in (0.9, 0.999)."""
    d_rnn = d_rnn or d_model
    dev = gen.device
    return {
        "w_x": init_linear(gen, d_model, d_rnn),
        "w_gate_branch": init_linear(gen, d_model, d_rnn),
        "conv_w": _normal(gen, (CONV_WIDTH, d_rnn), 0.1),
        "conv_b": torch.zeros((d_rnn,), device=dev),
        "w_input_gate": init_linear(gen, d_rnn, d_rnn),
        "w_rec_gate": init_linear(gen, d_rnn, d_rnn),
        "lam": torch.linspace(2.0, 6.0, d_rnn, device=dev),
        "w_out": init_linear(gen, d_rnn, d_model),
    }


def rglru_block_serving(x, p: Params, *, policy: PositPolicy, state,
                        num_new=None):
    """x [B, S, d] -> (out [B, S, d], (h_fin, conv_tail)).

    state = (h0 [B, d], conv_state [B, K-1, d]): f32 tensors or PositArray
    pool slots; h_fin comes back in h0's representation, the conv tail as
    raw f32 values of the last K-1 valid inputs (the caller re-encodes it
    with backends.store_state).  num_new [B] masks ragged chunks."""
    h0, conv_state = state
    pcfg = policy.kv_cache
    S = x.shape[1]
    K = p["conv_w"].shape[0]
    branch = linear(x, p["w_x"], policy)
    xp = rt_values(torch.cat([state_f32(conv_state).to(branch.dtype),
                              branch], dim=1), pcfg).to(branch.dtype)
    conv = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(K)) \
        + p["conv_b"]
    conv = conv.to(x.dtype)

    # the gates read the conv output; a and b are batched projections, only
    # the h recurrence itself is sequential
    r = torch.sigmoid(linear(conv, p["w_rec_gate"], policy))
    i = torch.sigmoid(linear(conv, p["w_input_gate"], policy))
    log_a = LRU_C * r.float() * torch.nn.functional.logsigmoid(p["lam"])
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * conv).float()

    h_seq, h_fin = ops.rglru_scan(a.contiguous(), b.contiguous(), h0,
                                  num_new=num_new, cfg_state=pcfg)
    gate = gelu(linear(x, p["w_gate_branch"], policy))
    out = linear(h_seq.to(x.dtype) * gate, p["w_out"], policy)

    if num_new is None:
        new_conv = xp[:, -(K - 1):]
    else:
        # row b's last K-1 valid conv inputs sit at xp[b, nn : nn + K - 1]
        idx = num_new.long()[:, None] + torch.arange(K - 1,
                                                     device=x.device)
        new_conv = torch.take_along_dim(
            xp, idx[:, :, None].expand(-1, -1, xp.shape[-1]), dim=1)
    return out, (h_fin, new_conv.float())
