"""Kernel dispatch for the model, serving and arithmetic code.

The counterpart of ``repro/kernels/ops.py``: `pw_matmul`, `decode`/`encode`,
the paged attention entry points, the contiguous `flash_prefill` and its
backward `flash_prefill_bwd`, and the posit arithmetic of ``repro.pnp``
(`elementwise`, `divide`, `gemm`; `gemm` on float operands is
differentiable, its backward two more GEMM launches).  The device of the
operands decides: CPU tensors take the plain versions, CUDA tensors the
kernels, with no fallback between them, so the reference's
FORCE_REFERENCE / FORCE_BWD_REFERENCE switches and BWD_FALLBACKS counter
have no counterpart: `plain_counts()` shows any plain call.  `KERNELS`
names every kernel wrapper with its plain version, for the launch
counters.

Operands may be `PositArray`s (the format travels with the array) or raw
storage ints with an explicit cfg; a posit result computed from
PositArray inputs comes back as a PositArray, raw inputs give raw bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.array import (PositArray, PositConfigMismatchError,
                                    is_float_dtype, is_int_dtype, result_cfg)
from repro_torch.core.types import PositConfig
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import posit_codec as _codec
from repro_torch.kernels import posit_elementwise as _ew
from repro_torch.kernels import posit_gemm as _gemm

# name -> (kernel wrapper, plain version); wrappers count `.launches`,
# plain versions `.calls`
KERNELS = {
    "decode_block": (_codec.decode_block, _codec.decode_block_plain),
    "encode_block": (_codec.encode_block, _codec.encode_block_plain),
    "paged_append": (_codec.paged_append, _codec.paged_append_plain),
    "pw_gemm": (_gemm.pw_gemm, _gemm.pw_gemm_plain),
    "paged_flash_decode": (_fa.paged_flash_decode,
                           _fa.paged_flash_decode_plain),
    "paged_flash_prefill": (_fa.paged_flash_prefill,
                            _fa.paged_flash_prefill_plain),
    "elementwise": (_ew.elementwise, _ew.elementwise_plain),
    "divide": (_ew.divide, _ew.divide_plain),
    "posit_gemm": (_gemm.posit_gemm, _gemm.posit_gemm_plain),
    "flash_prefill": (_fa.flash_prefill_contiguous,
                      _fa.flash_prefill_contiguous_plain),
    "flash_prefill_bwd_dq": (_fa.flash_prefill_bwd_dq,
                             _fa.flash_prefill_bwd_dq_plain),
    "flash_prefill_bwd_dkv": (_fa.flash_prefill_bwd_dkv,
                              _fa.flash_prefill_bwd_dkv_plain),
}


def reset_counters() -> None:
    for kernel, plain in KERNELS.values():
        kernel.launches = 0
        plain.calls = 0
    _gemm.posit_gemm.transpose_a_launches = 0


def launch_counts() -> dict[str, int]:
    """Launches per kernel; `posit_gemm_transpose_a` is the part of
    `posit_gemm`'s count that ran the dW form."""
    counts = {name: k.launches for name, (k, _) in KERNELS.items()}
    counts["posit_gemm_transpose_a"] = _gemm.posit_gemm.transpose_a_launches
    return counts


def plain_counts() -> dict[str, int]:
    return {name: p.calls for name, (_, p) in KERNELS.items()}


def _split(x, cfg: PositConfig | None):
    """(operand, explicit cfg) -> (raw tensor, cfg or None, was_posit)."""
    if isinstance(x, PositArray):
        if cfg is not None and cfg != x.cfg:
            raise PositConfigMismatchError(
                f"explicit cfg {cfg} contradicts operand format {x.cfg}")
        return x.bits, x.cfg, True
    return x, cfg, False


def _posit(x, cfg: PositConfig | None):
    """A posit payload operand -> (bits, cfg); the format is required."""
    bits, cfg, _ = _split(x, cfg)
    if cfg is None:
        raise TypeError("posit payload needs a PositArray or an explicit cfg")
    return bits, cfg


def pw_matmul(x: torch.Tensor, w, cfg: PositConfig | None = None, *,
              transpose_b: bool = False) -> torch.Tensor:
    """[..., k] @ posit weight [k, n] -> f32 [..., n] (the linear layer);
    transpose_b: w stored [n, k] (the tied unembedding table)."""
    bits, cfg = _posit(w, cfg)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    out = _gemm.pw_gemm(x2, bits, cfg, transpose_b=transpose_b)
    return out.reshape(*lead, bits.shape[0] if transpose_b else bits.shape[1])


def decode(p, cfg: PositConfig | None = None) -> torch.Tensor:
    """Posit payload -> f32 values."""
    bits, cfg = _posit(p, cfg)
    return _codec.decode_block(bits, cfg)


def encode(v: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """f32 values -> posit payload bits (raw)."""
    return _codec.encode_block(v, cfg)


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                           window=None):
    """q [B, H, D] over (PositArray or float) pages -> [B, H, D]."""
    kb, vb, cfg = _unwrap_pages(k_pages, v_pages)
    return _fa.paged_flash_decode(q, kb, vb, page_table, seq_lens,
                                  cfg_kv=cfg, window=window)


def paged_prefill_attention(q, k_pages, v_pages, page_table, seq_lens,
                            q_offset, *, causal=True, window=None,
                            softcap=None):
    """q [B, H, Sq, D] over (PositArray or float) pages -> [B, H, Sq, D]."""
    kb, vb, cfg = _unwrap_pages(k_pages, v_pages)
    return _fa.paged_flash_prefill(q, kb, vb, page_table, seq_lens, q_offset,
                                   cfg_kv=cfg, causal=causal, window=window,
                                   softcap=softcap)


def paged_append(k, v, k_pages, v_pages, page_table, seq_lens,
                 num_new) -> None:
    """Encode and scatter new K/V tokens into the pools, in place."""
    kb, vb, cfg = _unwrap_pages(k_pages, v_pages)
    _codec.paged_append(k, v, kb, vb, page_table, seq_lens, num_new, cfg)


def _unwrap_pages(k_pages, v_pages):
    """(k, v) pools -> raw buffers + format; both posit or both float."""
    if isinstance(k_pages, PositArray) != isinstance(v_pages, PositArray):
        raise TypeError("k and v pages must both be PositArray or both raw")
    if isinstance(k_pages, PositArray):
        k_pages.same_format(v_pages)
        return k_pages.bits, v_pages.bits, k_pages.cfg
    return k_pages, v_pages, None


# --------------------------------------------------------------------------
# posit arithmetic (PADD/PSUB/PMUL/PFMADD/PDIV) and the quire GEMM
# --------------------------------------------------------------------------
def _resolve_elementwise(op: str, inputs, cfg: PositConfig | None):
    """PositArray resolution for the elementwise-shaped ops -> (raw tensors
    broadcast to one shape, cfg, any_posit).  Raw companions of PositArray
    operands must be payload ints: python scalars and float tensors are
    values, and consuming them as bit patterns would be silent corruption."""
    any_posit = any(isinstance(x, PositArray) for x in inputs)
    if any_posit:
        cfg = result_cfg(*inputs, cfg=cfg)
        for x in inputs:
            if isinstance(x, PositArray):
                continue
            dt = getattr(x, "dtype", None)
            if (isinstance(x, (bool, int, float, complex))
                    or (dt is not None and is_float_dtype(dt))):
                raise TypeError(
                    f"{op}: cannot mix a PositArray with a python scalar or "
                    f"float array; encode values with pnp.asarray(x, cfg) "
                    f"or wrap payload bits with pnp.frombits")
    if cfg is None:
        raise TypeError(f"{op} needs PositArray inputs or an explicit cfg")
    raw = [x.bits if isinstance(x, PositArray) else x for x in inputs]
    dev = next((t.device for t in raw if isinstance(t, torch.Tensor)), None)
    raw = [t if isinstance(t, torch.Tensor) else torch.as_tensor(t, device=dev)
           for t in raw]
    # broadcast here, not in the kernels: they take same-shaped operands
    shape = torch.broadcast_shapes(*(t.shape for t in raw))
    return tuple(t.expand(shape) for t in raw), cfg, any_posit


def elementwise(op: str, *inputs, cfg: PositConfig | None = None):
    """PADD/PSUB/PMUL ("add"/"sub"/"mul") or PFMADD ("fma", three operands),
    lane-wise with broadcasting."""
    raw, cfg, any_posit = _resolve_elementwise(f"elementwise('{op}')",
                                               inputs, cfg)
    out = _ew.elementwise(op, *raw, cfg=cfg)
    return PositArray(out, cfg) if any_posit else out


def divide(a, b, *, cfg: PositConfig | None = None,
           mode: str = "poly_corrected", nr_rounds: int = 1):
    """PDIV lane-wise with broadcasting; mode in {"exact", "poly",
    "poly_corrected", "pacogen"}."""
    (a, b), cfg, any_posit = _resolve_elementwise("divide", (a, b), cfg)
    out = _ew.divide(a, b, cfg=cfg, mode=mode, nr_rounds=nr_rounds)
    return PositArray(out, cfg) if any_posit else out


def gemm(a, b, *, cfg_a: PositConfig | None = None,
         cfg_b: PositConfig | None = None,
         cfg_out: PositConfig | None = None, out_posit: bool = False,
         transpose_b: bool = False):
    """[m, k] @ [k, n] with posit operands decoded in the kernel and an f32
    accumulator; posit bits of cfg_out (one rounding) when out_posit.  A
    float operand (cfg None) is an activation and skips the decode.  The
    f32 result is differentiable in its float operands (`_GemmMM`); posit
    operands and posit results carry no gradient."""
    a, cfg_a, a_posit = _split(a, cfg_a)
    b, cfg_b, b_posit = _split(b, cfg_b)
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    # cfg-less int operands would be multiplied as integer values: posit
    # payload bits always need their format
    for raw, raw_cfg in ((a, cfg_a), (b, cfg_b)):
        if raw_cfg is None and is_int_dtype(raw.dtype):
            raise TypeError(
                "gemm: int payload bits need their format; wrap them with "
                "pnp.frombits(bits, cfg) or pass cfg_a/cfg_b")
    if out_posit and cfg_out is None:
        if cfg_a is not None and cfg_b is not None and cfg_a != cfg_b:
            raise PositConfigMismatchError(
                f"mixed-format gemm ({cfg_a} @ {cfg_b}) with out_posit needs "
                f"an explicit cfg_out")
        cfg_out = cfg_a if cfg_a is not None else cfg_b
    if cfg_a is None:
        a = a.to(torch.float32)
    if cfg_b is None:
        b = b.to(torch.float32)
    if not out_posit:
        return _GemmMM.apply(a, b, cfg_a, cfg_b, transpose_b)
    if cfg_a is None and cfg_b is not None:
        # posit out is the single rounding of the pw form's f32 result
        out = _codec.encode_block(_gemm_f32(a, b, cfg_a, cfg_b, transpose_b),
                                  cfg_out)
    else:
        out = _gemm.posit_gemm(a, b, cfg_a=cfg_a, cfg_b=cfg_b,
                               cfg_out=cfg_out, out_posit=True,
                               transpose_b=transpose_b)
    if a_posit or b_posit:
        return PositArray(out, cfg_out)
    return out


def _gemm_f32(a, b, cfg_a, cfg_b, transpose_b):
    if cfg_a is None and cfg_b is not None:
        # an f32 activation against posit weights is the pw form (its
        # skinny kernel at M <= 8)
        return _gemm.pw_gemm(a, b, cfg_b, transpose_b=transpose_b)
    return _gemm.posit_gemm(a, b, cfg_a=cfg_a, cfg_b=cfg_b,
                            transpose_b=transpose_b)


class _GemmMM(torch.autograd.Function):
    """The f32-out gemm with the reference's `_gemm_mm` VJP: dA = G @ B^T
    and dB = A^T @ G through the same posit_gemm kernel (transpose_b /
    transpose_a index the stored operands, so no transposed copy exists).
    Posit operands carry no tangent: training crosses the posit boundary
    through the straight-through estimator."""

    @staticmethod
    def forward(ctx, a, b, cfg_a, cfg_b, transpose_b):
        ctx.save_for_backward(a, b)
        ctx.cfgs = (cfg_a, cfg_b, transpose_b)
        return _gemm_f32(a, b, cfg_a, cfg_b, transpose_b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        cfg_a, cfg_b, transpose_b = ctx.cfgs
        g = g.to(torch.float32).contiguous()
        da = db = None
        if cfg_a is None and ctx.needs_input_grad[0]:
            # b is [k, n] (or [n, k]): dA contracts g with the other axis
            da = _gemm.posit_gemm(g, b, cfg_a=None, cfg_b=cfg_b,
                                  transpose_b=not transpose_b)
        if cfg_b is None and ctx.needs_input_grad[1]:
            if transpose_b:
                db = _gemm.posit_gemm(g, a, cfg_a=None, cfg_b=cfg_a,
                                      transpose_a=True)
            else:
                db = _gemm.posit_gemm(a, g, cfg_a=cfg_a, cfg_b=None,
                                      transpose_a=True)
        return da, db, None, None, None


# --------------------------------------------------------------------------
# the contiguous flash prefill (training forward and backward)
# --------------------------------------------------------------------------
def per_batch(x, B: int, device) -> torch.Tensor:
    """A scalar or [B]/[1] length or offset -> [B] int32 on `device`."""
    t = torch.as_tensor(x, device=device).to(torch.int32).reshape(-1)
    return t.expand(B).contiguous()


def flash_prefill(q, k, v, kv_len, q_offset, *,
                  cfg_kv: PositConfig | None = None, causal: bool = True,
                  window=None, softcap=None, return_lse: bool = False):
    """Fused prefill over a contiguous KV cache (GQA layout): q [B, H, Sq,
    D] x k/v [B, n_kv, Skv, D] (float, or PositArray / raw posit ints with
    cfg_kv, decoded tile by tile) -> [B, H, Sq, D] f32, and the row
    log-sum-exps [B, H, Sq] with return_lse (the backward's residual).
    kv_len and q_offset are scalars or [B]."""
    kb, vb, cfg = _unwrap_pages(k, v)
    cfg = cfg if cfg is not None else cfg_kv
    B = q.shape[0]
    return _fa.flash_prefill_contiguous(
        q.to(torch.float32), kb, vb, per_batch(kv_len, B, q.device),
        per_batch(q_offset, B, q.device), cfg_kv=cfg, causal=causal,
        window=window, softcap=softcap, return_lse=return_lse)


def flash_prefill_bwd(q, k, v, o, lse, g, kv_len, q_offset, *, n_kv: int,
                      cfg_kv: PositConfig | None = None, causal: bool = True,
                      window=None, softcap=None):
    """(dQ, dK, dV) of flash_prefill through the flash backward kernels
    (dQ sweeps kv tiles, dK/dV sweep q tiles, scores rebuilt from the
    saved lse); dK = dV = None for posit KV."""
    kb, vb, cfg = _unwrap_pages(k, v)
    cfg = cfg if cfg is not None else cfg_kv
    if kb.shape[1] != n_kv:
        raise ValueError(f"flash_prefill_bwd: k has {kb.shape[1]} kv heads, "
                         f"n_kv={n_kv}")
    B = q.shape[0]
    return _fa.flash_prefill_bwd_contiguous(
        q.to(torch.float32), kb, vb, o, lse, g,
        per_batch(kv_len, B, q.device), per_batch(q_offset, B, q.device),
        cfg_kv=cfg, causal=causal, window=window, softcap=softcap)
