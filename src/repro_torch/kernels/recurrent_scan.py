"""K12 and K13: the recurrent scans of the serving path
(``csrc/recurrent_scan.cu``).

`wkv_scan` replaces ``repro/kernels/recurrent_scan.py::wkv_scan_pallas``
(:107; its pallas_call at :132), the RWKV6 WKV recurrence; `rglru_scan`
replaces ``::rglru_scan_pallas`` (:203; pallas_call at :224), the RG-LRU
recurrence of Griffin / RecurrentGemma.  The carried state is posit bits
(decoded and encoded inside the kernel), or f32 with or without a
per-token round trip through `cfg_state`; `num_new` [B] masks ragged
chunks.  CPU tensors take the plain versions (`ref.wkv_scan_ref`,
`ref.rglru_scan_ref`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PositConfig
from repro_torch.kernels import build, ref

_DH_MAX = 64


def _state_dtype(s, cfg_state: PositConfig | None, posit_state: bool, fn):
    """Check the state's storage against its mode -> (dtype code, n, es)."""
    if posit_state:
        if cfg_state is None:
            raise TypeError(f"{fn}: posit state needs its cfg_state")
        want = getattr(torch, cfg_state.storage_dtype_name)
    else:
        want = torch.float32
    if s.dtype != want:
        raise TypeError(f"{fn}: state must be {want} (posit_state="
                        f"{posit_state}, cfg_state={cfg_state}), got "
                        f"{s.dtype}")
    if cfg_state is not None and cfg_state.n > 16:
        raise NotImplementedError(f"{fn}: {cfg_state}: the kernel covers "
                                  f"n <= 16")
    n, es = (cfg_state.n, cfg_state.es) if cfg_state is not None else (0, 0)
    return build.DTYPE_CODE[want], n, es


def _f32(fn, *tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: inputs must be float32, got {t.dtype}")
    return [t.contiguous() for t in tensors]


def wkv_scan_plain(r, k, v, logw, u, s0, num_new, *,
                   cfg_state: PositConfig | None, posit_state: bool):
    wkv_scan_plain.calls += 1
    return ref.wkv_scan_ref(r, k, v, logw, u, s0, num_new,
                            cfg_state=cfg_state, posit_state=posit_state)


def wkv_scan(r, k, v, logw, u, s0, num_new, *,
             cfg_state: PositConfig | None, posit_state: bool):
    """K12: r/k/v/logw [B, H, T, dh] f32, u [H, dh] f32, s0 [B, H, dh, dh]
    (posit ints of cfg_state when posit_state, else f32), num_new [B] int32
    -> (y [B, H, T, dh] f32, the final state in s0's representation)."""
    if r.device.type == "cpu":
        return wkv_scan_plain(r, k, v, logw, u, s0, num_new,
                              cfg_state=cfg_state, posit_state=posit_state)
    lib = build.library("recurrent_scan")
    code, n, es = _state_dtype(s0, cfg_state, posit_state, "wkv_scan")
    r, k, v, logw, u = _f32("wkv_scan", r, k, v, logw, u)
    s0 = s0.contiguous()
    nn = num_new.to(torch.int32).contiguous()
    build.check_cuda_tensors("wkv_scan", r, k, v, logw, u, s0, nn)
    if r.ndim != 4:
        raise ValueError(f"wkv_scan: r must be [B,H,T,dh], got "
                         f"{tuple(r.shape)}")
    B, H, T, dh = r.shape
    if (k.shape != r.shape or v.shape != r.shape
            or logw.shape != r.shape or u.shape != (H, dh)
            or s0.shape != (B, H, dh, dh) or nn.shape != (B,)):
        raise ValueError(f"wkv_scan: want r/k/v/logw [B,H,T,dh], u [H,dh], "
                         f"s0 [B,H,dh,dh], num_new [B]; got {tuple(r.shape)}, "
                         f"{tuple(u.shape)}, {tuple(s0.shape)}, "
                         f"{tuple(nn.shape)}")
    if dh > _DH_MAX:
        raise ValueError(f"wkv_scan: head_dim {dh} > {_DH_MAX}")
    y = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    if B == 0 or H == 0:
        return y, s_out
    rc = lib.wkv_scan(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      logw.data_ptr(), u.data_ptr(), s0.data_ptr(),
                      nn.data_ptr(), y.data_ptr(), s_out.data_ptr(), B, H, T,
                      dh, code, n, es, build.stream(r))
    wkv_scan.launches += 1
    build.check_launch(rc, "wkv_scan")
    return y, s_out


def rglru_scan_plain(a, b, h0, num_new, *, cfg_state: PositConfig | None,
                     posit_state: bool):
    rglru_scan_plain.calls += 1
    return ref.rglru_scan_ref(a, b, h0, num_new, cfg_state=cfg_state,
                              posit_state=posit_state)


def rglru_scan(a, b, h0, num_new, *, cfg_state: PositConfig | None,
               posit_state: bool):
    """K13: a/b [B, T, d] f32, h0 [B, d] (posit ints of cfg_state when
    posit_state, else f32), num_new [B] int32 -> (h_seq [B, T, d] f32, the
    final h in h0's representation)."""
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0, num_new, cfg_state=cfg_state,
                                posit_state=posit_state)
    lib = build.library("recurrent_scan")
    code, n, es = _state_dtype(h0, cfg_state, posit_state, "rglru_scan")
    a, b = _f32("rglru_scan", a, b)
    h0 = h0.contiguous()
    nn = num_new.to(torch.int32).contiguous()
    build.check_cuda_tensors("rglru_scan", a, b, h0, nn)
    if a.ndim != 3:
        raise ValueError(f"rglru_scan: a must be [B,T,d], got "
                         f"{tuple(a.shape)}")
    B, T, d = a.shape
    if (b.shape != a.shape or h0.shape != (B, d)
            or nn.shape != (B,)):
        raise ValueError(f"rglru_scan: want a/b [B,T,d], h0 [B,d], num_new "
                         f"[B]; got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}, {tuple(nn.shape)}")
    y = torch.empty_like(a)
    h_out = torch.empty_like(h0)
    if B == 0 or d == 0:
        return y, h_out
    rc = lib.rglru_scan(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                        nn.data_ptr(), y.data_ptr(), h_out.data_ptr(), B, T,
                        d, code, n, es, build.stream(a))
    rglru_scan.launches += 1
    build.check_launch(rc, "rglru_scan")
    return y, h_out


wkv_scan.launches = 0
rglru_scan.launches = 0
wkv_scan_plain.calls = 0
rglru_scan_plain.calls = 0
