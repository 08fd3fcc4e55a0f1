"""Plain PyTorch versions of every kernel (the per-kernel golden models).

Each mirrors the arithmetic of the JAX reference's jnp path (the path
``repro/kernels/ops.py`` dispatches on CPU): ``kernels/ref.py`` for the
GEMM, the codec and the posit arithmetic, ``serving/paged_kv.py`` for the
append and the page gather, and ``models/blocks.py::_blockwise_jnp`` for
attention.  The kernel modules
call these for CPU tensors; ``chip_smoke.py`` holds each kernel against
them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import ops as pops
from repro_torch.core.convert import f32_to_posit
from repro_torch.core.decode import decode_to_f32
from repro_torch.core.types import PositConfig

_NEG = -1e30


def decode_ref(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    return decode_to_f32(p, cfg)


def encode_ref(v: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    return f32_to_posit(v.to(torch.float32), cfg)


def values(buf: torch.Tensor, cfg: PositConfig | None) -> torch.Tensor:
    """Stored values -> f32 (posit decode, or a float cast)."""
    return decode_to_f32(buf, cfg) if cfg is not None else buf.float()


def posit_gemm_ref(a: torch.Tensor, b: torch.Tensor, *,
                   cfg_a: PositConfig | None, cfg_b: PositConfig | None,
                   cfg_out: PositConfig | None = None, out_posit: bool = False,
                   transpose_a: bool = False,
                   transpose_b: bool = False) -> torch.Tensor:
    """[m, k] @ [k, n] -> f32, or posit bits of cfg_out with one rounding
    when out_posit; a stored [k, m] (transpose_a) or b stored [n, k]
    (transpose_b) is contracted on its k axis.  A cfg of None means that
    operand is already float."""
    af = values(a, cfg_a)
    bf = values(b, cfg_b)
    acc = (af.T if transpose_a else af) @ (bf.T if transpose_b else bf)
    return f32_to_posit(acc, cfg_out) if out_posit else acc


def elementwise_ref(op: str, *inputs, cfg: PositConfig) -> torch.Tensor:
    fn = {"add": pops.padd, "sub": pops.psub, "mul": pops.pmul,
          "fma": pops.pfma}[op]
    return fn(*inputs, cfg)


def divide_ref(a, b, *, cfg: PositConfig, mode: str = "poly_corrected",
               nr_rounds: int = 1) -> torch.Tensor:
    return pops.pdiv(a, b, cfg, mode=mode, nr_rounds=nr_rounds)


def paged_append_ref(k, v, k_pages, v_pages, page_table, seq_lens, num_new,
                     cfg: PositConfig | None) -> None:
    """Write token j < num_new[i] of sequence i at position seq_lens[i] + j
    of its pages, in place; masked tokens and positions past the table are
    dropped.  k, v [B, n_kv, S, D] f32; pages [P, n_kv, page, D]."""
    B, n_kv, S, D = k.shape
    page, W = k_pages.shape[2], page_table.shape[1]
    pos = seq_lens[:, None] + torch.arange(S, device=k.device)[None, :]
    slot = pos // page
    valid = ((torch.arange(S, device=k.device)[None, :] < num_new[:, None])
             & (slot < W))
    pg = torch.gather(page_table, 1, slot.clamp(0, W - 1).long())
    valid &= (pg >= 0) & (pg < k_pages.shape[0])
    b_idx, s_idx = valid.nonzero(as_tuple=True)
    dst_pg, dst_off = pg[b_idx, s_idx].long(), (pos[b_idx, s_idx] % page).long()
    for vals, pages in ((k, k_pages), (v, v_pages)):
        new = vals[b_idx, :, s_idx, :]                   # [T, n_kv, D]
        new = (encode_ref(new, cfg) if cfg is not None
               else new.to(pages.dtype))
        pages[dst_pg, :, dst_off, :] = new


def gather_pages(buf: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Dense view [B, n_kv, W*page, D] of a paged pool [P, n_kv, page, D]."""
    B, W = table.shape
    _, n_kv, page, D = buf.shape
    g = buf[table.long()]                                # [B, W, n_kv, page, D]
    return g.permute(0, 2, 1, 3, 4).reshape(B, n_kv, W * page, D)


def blockwise_attention_ref(q, k, v, *, n_kv: int, causal: bool, q_off,
                            window, softcap, kv_len, cfg_kv=None,
                            q_chunk: int = 512, kv_chunk: int = 512):
    """GQA flash-style attention, the torch mirror of _blockwise_jnp.

    q [B, H, Sq, D] f32; k/v [B, n_kv, Skv, D] raw storage (posit ints when
    cfg_kv is set); q_off and kv_len are [B] or [1] int tensors.  Sq == 1
    takes the two-pass decode form, Sq > 1 the chunked online softmax, as
    the reference does.
    """
    B, H, Sq, D = q.shape
    G = H // n_kv
    Skv = k.shape[2]
    scale = D ** -0.5
    qf = q.float()
    kv_len = kv_len.reshape(-1)
    q_off = q_off.reshape(-1)

    if Sq == 1:
        kf, vf = values(k, cfg_kv), values(v, cfg_kv)
        if G > 1:
            kf = kf.repeat_interleave(G, dim=1)
            vf = vf.repeat_interleave(G, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        kpos = torch.arange(Skv, device=q.device)
        valid = kpos[None, :] < kv_len[:, None]
        if window is not None:
            valid = valid & (kpos[None, :] > kv_len[:, None] - 1 - window)
        s = torch.where(valid[:, None, None, :], s, _NEG)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        return out / p.sum(dim=-1, keepdim=True)

    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    pq, pk = (-Sq) % qc, (-Skv) % kc
    qp = torch.nn.functional.pad(qf, (0, 0, 0, pq)) if pq else qf
    kp = torch.nn.functional.pad(k, (0, 0, 0, pk)) if pk else k
    vp = torch.nn.functional.pad(v, (0, 0, 0, pk)) if pk else v
    nq, nk = (Sq + pq) // qc, (Skv + pk) // kc
    outs = []
    for qi in range(nq):
        q_tile = qp[:, :, qi * qc:(qi + 1) * qc]
        qpos = (q_off[:, None] + qi * qc
                + torch.arange(qc, device=q.device)[None, :])   # [B|1, qc]
        m = torch.full((B, H, qc), _NEG, device=q.device)
        l = torch.zeros((B, H, qc), device=q.device)
        acc = torch.zeros((B, H, qc, D), device=q.device)
        for ki in range(nk):
            k_tile = values(kp[:, :, ki * kc:(ki + 1) * kc], cfg_kv)
            v_tile = values(vp[:, :, ki * kc:(ki + 1) * kc], cfg_kv)
            if G > 1:
                k_tile = k_tile.repeat_interleave(G, dim=1)
                v_tile = v_tile.repeat_interleave(G, dim=1)
            kpos = ki * kc + torch.arange(kc, device=q.device)
            s = torch.einsum("bhqd,bhkd->bhqk", q_tile, k_tile) * scale
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            valid = kpos[None, None, :] < kv_len[:, None, None]
            if causal:
                valid = valid & (qpos[:, :, None] >= kpos[None, None, :])
            if window is not None:
                valid = valid & (qpos[:, :, None] - kpos[None, None, :]
                                 < window)
            s = torch.where(valid[:, None], s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, v_tile)
            m = m_new
        outs.append(acc / torch.where(l == 0, 1.0, l)[..., None])
    return torch.cat(outs, dim=2)[:, :, :Sq]


def paged_decode_ref(q, k_pages, v_pages, page_table, seq_lens, *,
                     cfg_kv: PositConfig | None, window=None):
    """q [B, H, D] over the pool -> [B, H, D] (gather + two-pass decode)."""
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    out = blockwise_attention_ref(
        q[:, :, None, :], k, v, n_kv=k_pages.shape[1], causal=True,
        q_off=seq_lens - 1, window=window, softcap=None, kv_len=seq_lens,
        cfg_kv=cfg_kv)
    return out[:, :, 0, :]


def paged_prefill_ref(q, k_pages, v_pages, page_table, seq_lens, q_offset, *,
                      cfg_kv: PositConfig | None, causal=True, window=None,
                      softcap=None):
    """q [B, H, Sq, D] over the pool -> [B, H, Sq, D] (gather + blockwise)."""
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    return blockwise_attention_ref(
        q, k, v, n_kv=k_pages.shape[1], causal=causal, q_off=q_offset,
        window=window, softcap=softcap, kv_len=seq_lens, cfg_kv=cfg_kv)


# --------------------------------------------------------------------------
# contiguous flash prefill: forward with lse, and its backward
# --------------------------------------------------------------------------
def _prefill_scores(q, k, kv_len, q_offset, cfg_kv, causal, window, softcap):
    """Grouped scores of q [B, H, Sq, D] against k [B, n_kv, Skv, D]:
    (s [B, n_kv, G, Sq, Skv] capped, valid mask broadcastable to s, the
    softcap chain factor 1 - tanh^2 of the unmasked scores or None, the
    decoded keys, the grouped queries)."""
    B, H, Sq, D = q.shape
    n_kv, Skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, n_kv, H // n_kv, Sq, D)
    kf = values(k, cfg_kv)
    s = torch.einsum("bngqd,bnkd->bngqk", qg, kf) * D ** -0.5
    dcap = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = t * softcap
        dcap = 1.0 - t * t
    qpos = (q_offset.reshape(-1)[:, None]
            + torch.arange(Sq, device=q.device)[None, :])       # [B|1, Sq]
    kpos = torch.arange(Skv, device=q.device)
    valid = kpos[None, None, :] < kv_len.reshape(-1)[:, None, None]
    if causal:
        valid = valid & (qpos[:, :, None] >= kpos[None, None, :])
    if window is not None:
        valid = valid & (qpos[:, :, None] - kpos[None, None, :] < window)
    return s, valid[:, None, None], dcap, kf, qg


def flash_prefill_ref(q, k, v, kv_len, q_offset, *,
                      cfg_kv: PositConfig | None = None, causal=True,
                      window=None, softcap=None, return_lse=False):
    """q [B, H, Sq, D] f32 over a contiguous k/v [B, n_kv, Skv, D] (f32,
    or posit ints of cfg_kv) -> out [B, H, Sq, D] f32, and lse [B, H, Sq]
    = m + log(l) when return_lse.  kv_len and q_offset are [B] (or [1])
    ints: row r sits at q_offset + r and sees kpos < kv_len, kpos <= qpos
    when causal, qpos - kpos < window.  A row that sees no key gets out =
    0 and lse = 0, as the kernel gives them (the reference's -1e30 masking
    averages the masked values there instead)."""
    B, H, Sq, D = q.shape
    s, valid, _, _, _ = _prefill_scores(q, k, kv_len, q_offset, cfg_kv,
                                        causal, window, softcap)
    vf = values(v, cfg_kv)
    any_key = valid.any(dim=-1, keepdim=True)
    m = torch.where(valid, s, float("-inf")).amax(dim=-1, keepdim=True)
    m = torch.where(any_key, m, 0.0)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bngqk,bnkd->bngqd", p, vf)
    out = (out / torch.where(l > 0, l, 1.0)).reshape(B, H, Sq, D)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), 0.0)
    return out, lse.reshape(B, H, Sq)


def flash_prefill_bwd_parts(q, k, v, do, lse, delta, kv_len, q_offset, *,
                            cfg_kv: PositConfig | None = None, causal=True,
                            window=None, softcap=None, dq=True, dkv=True):
    """The flash backward from the saved lse and delta = rowsum(dO * O):
    p = exp(s - lse) under the forward's masks, ds = p (dO.v - delta) times
    the softcap chain factor; returns (dq or None, dk or None, dv or
    None), dk/dv group-summed to [B, n_kv, Skv, D]."""
    B, H, Sq, D = q.shape
    n_kv = k.shape[1]
    G = H // n_kv
    scale = D ** -0.5
    s, valid, dcap, kf, qg = _prefill_scores(q, k, kv_len, q_offset, cfg_kv,
                                             causal, window, softcap)
    vf = values(v, cfg_kv)
    p = torch.where(valid, torch.exp(s - lse.float().reshape(
        B, n_kv, G, Sq, 1)), 0.0)
    dog = do.float().reshape(B, n_kv, G, Sq, D)
    dp = torch.einsum("bngqd,bnkd->bngqk", dog, vf)
    ds = p * (dp - delta.float().reshape(B, n_kv, G, Sq, 1))
    if dcap is not None:
        ds = ds * dcap
    dq_ = dk_ = dv_ = None
    if dq:
        dq_ = (torch.einsum("bngqk,bnkd->bngqd", ds, kf)
               * scale).reshape(B, H, Sq, D)
    if dkv:
        dk_ = torch.einsum("bngqk,bngqd->bnkd", ds, qg) * scale
        dv_ = torch.einsum("bngqk,bngqd->bnkd", p, dog)
    return dq_, dk_, dv_


def flash_prefill_bwd_ref(q, k, v, o, lse, do, kv_len, q_offset, *,
                          cfg_kv: PositConfig | None = None, causal=True,
                          window=None, softcap=None):
    """(dq, dk, dv) of flash_prefill_ref; dk = dv = None for posit KV
    (storage ints carry no gradient)."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return flash_prefill_bwd_parts(
        q, k, v, do, lse, delta, kv_len, q_offset, cfg_kv=cfg_kv,
        causal=causal, window=window, softcap=softcap, dkv=cfg_kv is None)
