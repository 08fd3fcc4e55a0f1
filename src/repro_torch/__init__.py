"""PyTorch port of `repro`: posit-quantized paged serving on an NVIDIA H100.

The package mirrors `repro`'s module layout (``core/decode.py`` here is the
counterpart of ``repro/core/decode.py``, and so on) and imports neither JAX
nor `repro`.  Plain tensor code is PyTorch; the four kernels on the serving
path (the posit codec, the posit-weight GEMM, paged decode and paged prefill
attention) are CUDA C++ for ``sm_90a`` under ``csrc/``, built at first use.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
the CPU runs only when the caller passes ``device="cpu"``, and then every
kernel wrapper takes its plain PyTorch version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
