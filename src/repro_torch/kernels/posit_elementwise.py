"""K5/K6: bit-exact posit arithmetic per lane (``csrc/posit_elementwise.cu``).

`elementwise` replaces ``repro/kernels/posit_elementwise.py::elementwise``
(:50; its pallas_call at :66, kernel ``_ew_kernel`` at :33): PADD, PSUB,
PMUL and PFMADD per lane.  `divide` replaces ``::divide`` (:110; pallas_calls
at :126 for the LUT and :138 for the other modes, kernels ``_div_kernel``
and ``_div_kernel_lut``): PDIV in the four modes, with `nr_rounds`
Newton-Raphson rounds.  Each lane runs the FPPU datapath of
``core/ops.py`` (decode -> int32 significand op -> RNE encode), so a
kernel is bit-identical to its plain version.  Both spend their time in
the integer pipes, well above the HBM-bytes bound (``chip_smoke.py`` prints
both, with the static SASS count per lane); see the source for the design.
"""
from __future__ import annotations

import torch

from repro_torch.core import recip as _recip
from repro_torch.core.ops import DIV_MODES
from repro_torch.core.types import PositConfig
from repro_torch.kernels import build, ref

# op -> (operand count, code of csrc/posit_elementwise.cu)
EW_OPS = {"add": (2, 0), "sub": (2, 1), "mul": (2, 2), "fma": (3, 3)}


def _storage(cfg: PositConfig) -> torch.dtype:
    if cfg.n > 16:
        raise NotImplementedError(f"{cfg}: the arithmetic kernels cover "
                                  f"n <= 16")
    return getattr(torch, cfg.storage_dtype_name)


def _operands(fn: str, inputs, cfg: PositConfig):
    """Same-shaped int payloads -> contiguous tensors of the storage dtype
    on one CUDA device (int32 patterns narrow exactly: only the low n bits
    are read)."""
    dt = _storage(cfg)
    shape = inputs[0].shape
    out = []
    for x in inputs:
        if x.shape != shape:
            raise ValueError(f"{fn}: operands must share one shape, got "
                             f"{[tuple(t.shape) for t in inputs]}")
        if x.dtype.is_floating_point or x.dtype.is_complex:
            raise TypeError(f"{fn}: posit payloads must be ints, got "
                            f"{x.dtype}")
        out.append(x.to(dt).contiguous())
    build.check_cuda_tensors(fn, *out)
    return out, dt


def elementwise_plain(op: str, *inputs, cfg: PositConfig) -> torch.Tensor:
    elementwise_plain.calls += 1
    return ref.elementwise_ref(op, *inputs, cfg=cfg)


def elementwise(op: str, *inputs, cfg: PositConfig) -> torch.Tensor:
    """Apply PADD/PSUB/PMUL/PFMADD lane-wise to same-shaped posit payloads;
    returns payload ints of the format's storage dtype."""
    if op not in EW_OPS:
        raise ValueError(f"unknown elementwise op {op!r}; divide has its "
                         f"own kernel")
    n_in, code = EW_OPS[op]
    if len(inputs) != n_in:
        raise TypeError(f"{op} takes {n_in} operands, got {len(inputs)}")
    if inputs[0].device.type == "cpu":
        return elementwise_plain(op, *inputs, cfg=cfg)
    lib = build.library("posit_elementwise")
    ins, dt = _operands(f"elementwise('{op}')", inputs, cfg)
    out = torch.empty(ins[0].shape, dtype=dt, device=ins[0].device)
    if out.numel() == 0:
        return out
    c = ins[2].data_ptr() if n_in == 3 else None
    rc = lib.posit_elementwise(code, ins[0].data_ptr(), ins[1].data_ptr(), c,
                               out.data_ptr(), out.numel(),
                               build.DTYPE_CODE[dt], cfg.n, cfg.es,
                               build.stream(out))
    elementwise.launches += 1
    build.check_launch(rc, "posit_elementwise")
    return out


def divide_plain(a, b, *, cfg: PositConfig, mode: str = "poly_corrected",
                 nr_rounds: int = 1) -> torch.Tensor:
    divide_plain.calls += 1
    return ref.divide_ref(a, b, cfg=cfg, mode=mode, nr_rounds=nr_rounds)


def divide(a, b, *, cfg: PositConfig, mode: str = "poly_corrected",
           nr_rounds: int = 1) -> torch.Tensor:
    """Lane-wise posit division a / b (paper §V-A datapath).  mode: "poly"
    (the paper's Alg. 1, approximate), "pacogen" (the Table II LUT
    baseline), "poly_corrected" / "exact" (correctly rounded)."""
    if mode not in DIV_MODES:
        raise ValueError(f"unknown division mode {mode!r}")
    if nr_rounds < 0:
        raise ValueError(f"nr_rounds must be >= 0, got {nr_rounds}")
    if a.device.type == "cpu":
        return divide_plain(a, b, cfg=cfg, mode=mode, nr_rounds=nr_rounds)
    lib = build.library("posit_elementwise")
    (a, b), dt = _operands("divide", (a, b), cfg)
    out = torch.empty(a.shape, dtype=dt, device=a.device)
    if out.numel() == 0:
        return out
    k1q, k2q = _recip.k_fixed()
    rc = lib.posit_divide(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                          _recip.pacogen_lut(a.device).data_ptr(),
                          out.numel(), DIV_MODES.index(mode), nr_rounds, k1q,
                          k2q, build.DTYPE_CODE[dt], cfg.n, cfg.es,
                          build.stream(out))
    divide.launches += 1
    build.check_launch(rc, "posit_divide")
    return out


elementwise.launches = 0
divide.launches = 0
elementwise_plain.calls = 0
divide_plain.calls = 0
