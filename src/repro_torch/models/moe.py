"""Mixture-of-Experts block: sort-based routing over the grouped posit GEMM.

The counterpart of ``repro/models/moe.py``.  Each token picks top_k of
n_experts from the router's softmax; its (token, k) pairs are sorted by
expert, the per-expert segment offsets are found on the device
(`torch.searchsorted`, never a host copy), and three grouped GEMMs
(`kernels.ops.grouped_matmul`, K10 forward and dX, K11 dW) run the
experts over their own rows only: posit expert tables stream at storage
width and only the active experts' tiles are read.  Training routes per
`group_size` tokens with arrival-order capacity drops; the combine
weights are renormalized over the kept experts (dropped pairs weigh 0).
Serving passes capacity_factor=None: nothing drops, so a token's output
does not depend on the other requests in its step.

Determinism: the reference combines with a scatter-add (``.at[tok].add``),
which on a GPU would be float atomics in a varying order.  Here every
row movement is a gather by a permutation (its backward adds into each
row once, so it is exact) and the top_k partial outputs meet in one
fixed-order sum, so a step is bit-reproducible and a token's output is
independent of its batch.

`_dispatch_oneshot`, the GShard one-hot capacity dispatch, is kept as the
port's own oracle for the tests; nothing on the main path reaches it, so
the reference's FORCE_DENSE / FORCE_GROUPED / DENSE_MOE_FALLBACKS have no
counterpart.  The expert-parallel parts (`_ep_ctx`, `block_psum`,
`block_grad_sync`) are the identity outside a tensor-parallel context and
are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.array import PositArray, is_int_dtype
from repro_torch.kernels import ops
from repro_torch.models.blocks import _normal
from repro_torch.quant.policy import PositPolicy, posit_cast_ste

Params = dict[str, Any]

_GLU = ("geglu", "swiglu")


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             act: str) -> Params:
    """The reference's distributions.  Its `_dense_init` takes fan_in =
    shape[0], which for the [E, d_model, d_ff] expert tables is E: w_up and
    w_gate have std E^-0.5 (1/8 at 64 experts), kept so that a port model
    has the reference's activation scales; w_down passes d_ff^-0.5, the
    router [d_model, E] has d_model^-0.5."""
    p = {
        "router": _normal(gen, (d_model, n_experts), d_model ** -0.5),
        "w_up": _normal(gen, (n_experts, d_model, d_ff), n_experts ** -0.5),
        "w_down": _normal(gen, (n_experts, d_ff, d_model), d_ff ** -0.5),
    }
    if act in _GLU:
        p["w_gate"] = _normal(gen, (n_experts, d_model, d_ff),
                              n_experts ** -0.5)
    return p


def _activate(gate, up, act: str):
    if act == "swiglu":
        return F.silu(gate) * up
    if act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if act == "gelu":
        return F.gelu(up, approximate="tanh")
    raise NotImplementedError(f"moe act {act!r} is not ported")


def _grouped_weight(w, policy: PositPolicy):
    """(operand, cfg) for grouped_matmul: posit storage passes through at
    storage width (the kernel decodes its tiles); float weights under a
    posit policy take the QAT round trip (`posit_cast_ste`)."""
    if isinstance(w, PositArray):
        return w, None
    if is_int_dtype(w.dtype):
        return w, policy.weights
    if policy is not None and policy.weights is not None:
        return posit_cast_ste(w, policy.weights), None
    return w, None


def _router_logits(xt, router, policy: PositPolicy):
    """[G, gs, d] -> [G, gs, E] f32.  A posit router streams through the
    posit GEMM; an f32 router (PTQ keeps it f32) takes the posit policy's
    round trip, as the reference's does in serving and training."""
    G, gs, d = xt.shape
    x2 = xt.reshape(G * gs, d).to(torch.float32)
    if isinstance(router, PositArray):
        out = ops.pw_matmul(x2, router)
    elif is_int_dtype(router.dtype):
        out = ops.pw_matmul(x2, router, policy.weights)
    else:
        if policy is not None and policy.weights is not None:
            router = posit_cast_ste(router, policy.weights)
        out = ops.gemm(x2, router)
    return out.reshape(G, gs, -1)


def _one_hot(idx, n: int):
    """int32 one-hot by comparison (no device-to-host read)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def _route(xt, p: Params, *, n_experts: int, top_k: int, cap: int,
           policy: PositPolicy):
    """(probs, gate_idx, onehot, pos, keep, comb_w): top-k over the router
    softmax, each pair's arrival position within its expert's dispatch
    group, the capacity mask, and combine weights renormalized over the
    kept experts only."""
    gs = xt.shape[1]
    probs = torch.softmax(_router_logits(xt, p["router"], policy), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)      # [G, gs, k]
    onehot = _one_hot(gate_idx, n_experts)
    if cap >= gs:
        # top-k ids are distinct per token, so an expert sees at most gs
        # arrivals per group: nothing can overflow (the serving setting)
        pos = None
        keep = torch.ones_like(gate_vals, dtype=torch.bool)
    else:
        pos = _arrival_positions(onehot)
        keep = pos < cap
    kept = gate_vals * keep
    comb_w = kept / kept.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_idx, onehot, pos, keep, comb_w


def _arrival_positions(onehot):
    """Per-(token, k) arrival position within its expert's dispatch group
    ([G, gs, k, E] int one-hot -> [G, gs, k])."""
    G, gs, top_k, E = onehot.shape
    flat = onehot.reshape(G, gs * top_k, E)
    pos = torch.cumsum(flat, dim=1) - 1
    return (pos * flat).sum(dim=-1).reshape(G, gs, top_k)


def _dispatch_grouped(xt, p: Params, *, n_experts: int, top_k: int,
                      act: str, policy: PositPolicy, gate_idx, comb_w):
    """Sort the (token, k) pairs by expert, run the grouped GEMMs over the
    experts' segments, un-permute and combine in a fixed order."""
    G, gs, d = xt.shape
    T = G * gs
    S = T * top_k
    dev = xt.device
    keys, order = torch.sort(gate_idx.reshape(S), stable=True)
    offsets = torch.searchsorted(
        keys, torch.arange(n_experts + 1, device=dev, dtype=keys.dtype)
    ).to(torch.int32)
    # pair i of the sorted order is row order[i] of the [T, top_k, d]
    # expansion: a gather by a permutation, whose backward is exact, and
    # the expansion's backward is a fixed-order sum over top_k
    x_pairs = xt.reshape(T, 1, d).to(torch.float32).expand(T, top_k, d)
    x_sorted = x_pairs.reshape(S, d).index_select(0, order)

    w_up, cfg_up = _grouped_weight(p["w_up"], policy)
    w_down, cfg_down = _grouped_weight(p["w_down"], policy)
    up = ops.grouped_matmul(x_sorted, w_up, offsets, cfg=cfg_up)
    gate = None
    if act in _GLU:
        w_gate, cfg_gate = _grouped_weight(p["w_gate"], policy)
        gate = ops.grouped_matmul(x_sorted, w_gate, offsets, cfg=cfg_gate)
    ye = ops.grouped_matmul(_activate(gate, up, act), w_down, offsets,
                            cfg=cfg_down)                          # [S, d]

    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(S, device=dev))
    y_pairs = ye.index_select(0, inv).reshape(T, top_k, d)
    out = (y_pairs * comb_w.reshape(T, top_k, 1)).sum(dim=1)
    return out.reshape(G, gs, d)


def _decoded(w, policy: PositPolicy):
    """Full-tensor f32 view of a (possibly posit) weight: the oracle only."""
    if isinstance(w, PositArray):
        return w.to_f32()
    if is_int_dtype(w.dtype):
        return ops.decode(w, policy.weights)
    if policy is not None and policy.weights is not None:
        return posit_cast_ste(w, policy.weights)
    return w


def _dispatch_oneshot(xt, p: Params, *, n_experts: int, top_k: int,
                      act: str, policy: PositPolicy, cap: int, gate_idx, pos,
                      keep, comb_w):
    """The GShard one-hot capacity dispatch: per-expert capacity slots,
    dispatch/combine one-hots and every expert table decoded whole.  The
    tests' oracle for the grouped path; the main path never runs it."""
    if pos is None:                       # no-overflow routing skipped it
        pos = _arrival_positions(_one_hot(gate_idx, n_experts))
    dt = xt.dtype
    onehot = F.one_hot(gate_idx, n_experts).to(dt)                 # [G,t,k,E]
    slot_oh = F.one_hot(torch.where(keep, pos, cap).long(),
                        cap + 1).to(dt)[..., :cap]                 # [G,t,k,C]
    disp = torch.einsum("gtke,gtkc->gtec", onehot, slot_oh)
    comb = torch.einsum("gtke,gtkc,gtk->gtec", onehot, slot_oh, comb_w)
    xe = torch.einsum("gtec,gtd->gecd", disp, xt)                  # [G,E,C,d]
    up = torch.einsum("gecd,edf->gecf", xe, _decoded(p["w_up"], policy))
    gate = (torch.einsum("gecd,edf->gecf", xe, _decoded(p["w_gate"], policy))
            if act in _GLU else None)
    ye = torch.einsum("gecf,efd->gecd", _activate(gate, up, act),
                      _decoded(p["w_down"], policy))
    return torch.einsum("gtec,gecd->gtd", comb, ye)


def moe_block(x, p: Params, *, n_experts: int, top_k: int, act: str,
              policy: PositPolicy, capacity_factor: float | None = 1.25,
              group_size: int = 128):
    """x [B, S, d] -> (out [B, S, d], aux_loss scalar).

    capacity_factor None disables overflow dropping (serving): every pair
    fits, so the routing groups do not matter and the whole step is one
    group.  Otherwise tokens route per `group_size` (B*S must divide into
    groups) with a per-group capacity of int(cf * gs * top_k / E) pairs per
    expert, dropped in arrival order.  aux_loss is the Switch
    load-balancing loss E * sum_e f_e * P_e.
    """
    Bsz, S, d = x.shape
    T = Bsz * S
    if capacity_factor is None:
        gs = cap = T
    else:
        gs = min(group_size, T)
        if T % gs:
            raise ValueError(f"moe_block: {T} tokens do not divide into "
                             f"dispatch groups of {gs}")
        cap = max(1, int(capacity_factor * gs * top_k / n_experts))
    xt = x.reshape(T // gs, gs, d)
    probs, gate_idx, onehot, pos, keep, comb_w = _route(
        xt, p, n_experts=n_experts, top_k=top_k, cap=cap, policy=policy)

    f = onehot.to(torch.float32).sum(dim=(0, 1, 2)) / (T * top_k)
    pm = probs.mean(dim=(0, 1))
    aux = n_experts * torch.sum(f * pm)

    out = _dispatch_grouped(xt, p, n_experts=n_experts, top_k=top_k, act=act,
                            policy=policy, gate_idx=gate_idx, comb_w=comb_w)
    return out.reshape(Bsz, S, d).to(x.dtype), aux
