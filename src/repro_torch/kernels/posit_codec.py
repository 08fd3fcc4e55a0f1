"""K1: the bulk posit codec, its one-pass round trip and the fused KV
append (``csrc/posit_codec.cu``).

Replaces ``repro/kernels/posit_codec.py::decode_block`` (:41) and
``::encode_block`` (:59); `paged_append` replaces the jnp encode + scatter
of ``repro/serving/paged_kv.py::paged_append_kv`` (:266).
`round_trip_block` is ``decode_block(encode_block(x))`` in one pass, the
function the reference's QAT cast and ``rt_values`` compute as one fused
expression.  All four are HBM-bound passes; see the source for the design.

`codec_split` mirrors the source's split of a pass into lanes and steps of
one float4; the C entries refuse a split that differs (cudaError 9).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PositConfig
from repro_torch.kernels import build, ref


def _posit_dtype(cfg: PositConfig) -> torch.dtype:
    if cfg.n > 16:
        raise NotImplementedError(f"{cfg}: the codec kernel covers n <= 16")
    return getattr(torch, cfg.storage_dtype_name)


def codec_split(count: int, f32_ptr: int, other_ptr: int,
                other_bytes: int) -> tuple[int, int]:
    """How a pass walks `count` elements -> (head, nvec): `head` elements
    lane by lane until the f32 side (at `f32_ptr`) is 16-byte aligned, then
    `nvec` steps of 4 elements (one float4; 4 posits of `other_bytes` each,
    or a float4 for the round trip, on the other side at `other_ptr`), then
    the tail lane by lane.  If the other side is not aligned to its 4
    elements there, every element is a lane (head = count)."""
    head = (-f32_ptr % 16) // 4
    if head > count or (other_ptr + other_bytes * head) % (4 * other_bytes):
        head = count
    return head, (count - head) // 4


# The source's constants (the CPU tests hold them to it): threads a block
# (one entry of each 256-entry table a thread) and steps a thread has in
# flight.
CODEC_THREADS = 256
STEPS_IN_FLIGHT = 2


def decode_block_plain(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    decode_block_plain.calls += 1
    return ref.decode_ref(p, cfg)


def decode_block(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Bulk posit storage ints -> exact f32 (NaR -> NaN), any shape."""
    if p.device.type == "cpu":
        return decode_block_plain(p, cfg)
    lib = build.library("posit_codec")
    if p.dtype != _posit_dtype(cfg):
        raise TypeError(f"decode_block: {cfg} bits must be "
                        f"{cfg.storage_dtype_name}, got {p.dtype}")
    p = p.contiguous()
    build.check_cuda_tensors("decode_block", p)
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    if p.numel() == 0:
        return out
    head, nvec = codec_split(p.numel(), out.data_ptr(), p.data_ptr(),
                             p.element_size())
    rc = lib.posit_decode_block(p.data_ptr(), out.data_ptr(), p.numel(),
                                head, nvec, build.DTYPE_CODE[p.dtype], cfg.n,
                                cfg.es, build.stream(p))
    decode_block.launches += 1
    build.check_launch(rc, "posit_decode_block")
    return out


def encode_block_plain(v: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    encode_block_plain.calls += 1
    return ref.encode_ref(v, cfg)


def encode_block(v: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Bulk f32 -> posit storage ints (RNE, saturating), any shape."""
    if v.device.type == "cpu":
        return encode_block_plain(v, cfg)
    lib = build.library("posit_codec")
    dt = _posit_dtype(cfg)
    v = v.to(torch.float32).contiguous()
    build.check_cuda_tensors("encode_block", v)
    out = torch.empty(v.shape, dtype=dt, device=v.device)
    if v.numel() == 0:
        return out
    head, nvec = codec_split(v.numel(), v.data_ptr(), out.data_ptr(),
                             out.element_size())
    rc = lib.posit_encode_block(v.data_ptr(), out.data_ptr(), v.numel(),
                                head, nvec, build.DTYPE_CODE[dt], cfg.n,
                                cfg.es, build.stream(v))
    encode_block.launches += 1
    build.check_launch(rc, "posit_encode_block")
    return out


def round_trip_block_plain(v: torch.Tensor,
                           cfg: PositConfig) -> torch.Tensor:
    round_trip_block_plain.calls += 1
    return ref.decode_ref(ref.encode_ref(v, cfg), cfg)


def round_trip_block(v: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """f32 -> f32 decode(encode(v)) in one pass (RNE, saturating; NaN and
    Inf -> NaR -> NaN), any shape: the values posit storage would hold."""
    if v.device.type == "cpu":
        return round_trip_block_plain(v, cfg)
    lib = build.library("posit_codec")
    _posit_dtype(cfg)
    v = v.to(torch.float32).contiguous()
    build.check_cuda_tensors("round_trip_block", v)
    out = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    if v.numel() == 0:
        return out
    head, nvec = codec_split(v.numel(), v.data_ptr(), out.data_ptr(), 4)
    rc = lib.posit_round_trip_block(v.data_ptr(), out.data_ptr(), v.numel(),
                                    head, nvec, cfg.n, cfg.es,
                                    build.stream(v))
    round_trip_block.launches += 1
    build.check_launch(rc, "posit_round_trip_block")
    return out


def paged_append_plain(k, v, k_pages, v_pages, page_table, seq_lens, num_new,
                       cfg: PositConfig | None) -> None:
    paged_append_plain.calls += 1
    ref.paged_append_ref(k, v, k_pages, v_pages, page_table, seq_lens,
                         num_new, cfg)


def paged_append(k, v, k_pages, v_pages, page_table, seq_lens, num_new,
                 cfg: PositConfig | None) -> None:
    """Encode k, v [B, n_kv, S, D] and write them into the pools in place.

    Token j of sequence i goes to position seq_lens[i] + j, i.e. page
    page_table[i, pos // page] at offset pos % page; tokens with
    j >= num_new[i] and positions past the table are dropped.  cfg None:
    float pages, values copied as they are.
    """
    if k.device.type == "cpu":
        return paged_append_plain(k, v, k_pages, v_pages, page_table,
                                  seq_lens, num_new, cfg)
    lib = build.library("posit_codec")
    dt = torch.float32 if cfg is None else _posit_dtype(cfg)
    if k_pages.dtype != dt or v_pages.dtype != dt:
        raise TypeError(f"paged_append: pages must be {dt}")
    k = k.to(torch.float32).contiguous()
    v = v.to(torch.float32).contiguous()
    page_table = page_table.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    num_new = num_new.to(torch.int32).contiguous()
    build.check_cuda_tensors("paged_append", k, v, k_pages, v_pages,
                             page_table, seq_lens, num_new)
    B, n_kv, S, D = k.shape
    P, n_kv_p, page, D_p = k_pages.shape
    if (n_kv_p, D_p) != (n_kv, D) or v.shape != k.shape:
        raise ValueError(f"paged_append: k {tuple(k.shape)} does not match "
                         f"pages {tuple(k_pages.shape)}")
    if k.numel() == 0:
        return None
    n, es = (cfg.n, cfg.es) if cfg is not None else (0, 0)
    rc = lib.posit_paged_append(
        k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(), num_new.data_ptr(),
        page_table.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), B,
        n_kv, S, D, page, page_table.shape[1], P, build.DTYPE_CODE[dt], n, es,
        build.stream(k))
    paged_append.launches += 1
    build.check_launch(rc, "posit_paged_append")
    return None


for _fn in (decode_block, encode_block, round_trip_block, paged_append):
    _fn.launches = 0
for _fn in (decode_block_plain, encode_block_plain, round_trip_block_plain,
            paged_append_plain):
    _fn.calls = 0
