"""Build the CUDA sources under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with one ``nvcc`` into its own shared
library with a plain C interface; all of them start together, so the
build takes as long as the slowest file.  Libraries go to ``build/`` at
the repository root, named by a hash of their sources and flags, so an
edited source rebuilds and an unchanged one loads as it is.  Nothing is
built or loaded when a module is imported: the first kernel launch, or an
explicit `build_all()`, does it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# sm_90a: Hopper.  No --use_fast_math: it changes expf, tanhf and division.
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# C entry points of each library: argument types (every one returns the
# cudaError_t of its launch as an int).
SIGNATURES = {
    "posit_codec": {
        "posit_decode_block": (_P, _P, _LL, _I, _I, _I, _P),
        "posit_encode_block": (_P, _P, _LL, _I, _I, _I, _P),
        "posit_paged_append": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _P),
    },
    "posit_gemm": {
        "posit_pw_gemm": (_P, _P, _P) + (_I,) * 7 + (_P,) + (_I,) * 4
        + (_LL, _P),
        "posit_gemm": (_P, _P, _P) + (_I,) * 14 + (_P,) + (_I,) * 4
        + (_LL, _P),
    },
    "posit_elementwise": {
        "posit_elementwise": (_I, _P, _P, _P, _P, _LL, _I, _I, _I, _P),
        "posit_divide": (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I,
                         _P),
    },
    "paged_attention": {
        "posit_paged_decode": (_P,) * 6 + (_I,) * 8 + (_F,) + (_I,) * 5
        + (_P,),
    },
    "flash_prefill": {
        "flash_prefill_fwd": (_P,) * 7 + (_I,) * 8 + (_F, _F) + (_I,) * 5
        + (_P,),
        "flash_prefill_paged_fwd": (_P,) * 7 + (_I,) * 10 + (_F, _F)
        + (_I,) * 5 + (_P,),
        "flash_prefill_bwd_dq": (_P,) * 9 + (_I,) * 8 + (_F, _F) + (_I,) * 5
        + (_P,),
        "flash_prefill_bwd_dkv": (_P,) * 10 + (_I,) * 8 + (_F, _F, _I, _I,
                                                          _P),
    },
    "grouped_gemm": {
        "posit_grouped_gemm": (_P, _P, _P, _P) + (_I,) * 12 + (_LL, _P),
        "posit_grouped_gemm_dw": (_P, _P, _P, _P) + (_I,) * 7 + (_LL, _P),
    },
    "recurrent_scan": {
        "wkv_scan": (_P,) * 9 + (_I,) * 7 + (_P,),
        "rglru_scan": (_P,) * 6 + (_I,) * 6 + (_P,),
        "posit_rt_check": (_I, _I, _I, _P, _P),
    },
}

# storage dtype -> the PositDtype code of csrc/posit_codec.cuh
DTYPE_CODE = {torch.float32: 0, torch.int8: 1, torch.int16: 2}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit default."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where library `name` of the current sources and flags is built."""
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA kernels need a CUDA device; none is "
                           "available (plain versions run for CPU tensors)")


def build_all(names=tuple(SIGNATURES)) -> float:
    """Compile every library of `names` that is not built yet, all at once.
    Returns the wall seconds spent; raises with nvcc's output on failure.
    ptxas's register and shared-memory report lands in build/<name>.log."""
    _require_cuda()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, log,
                     subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        msgs = "\n".join(f"--- {n}\n{(BUILD_DIR / f'{n}.log').read_text()}"
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    _require_cuda()
    path = library_path(name)
    if not path.exists():
        build_all((name,))
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(rc: int, fn: str) -> None:
    """Raise if a launch returned a CUDA error (refused launches never run,
    and a later synchronize would not report them)."""
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {rc}")


def check_cuda_tensors(fn: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{fn}: tensors must share one CUDA device, got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: tensors must be contiguous")
