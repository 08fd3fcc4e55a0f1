"""Posit dtype policy: which tensor classes live as posit payload ints.

The counterpart of ``repro/quant/policy.py``.  `PositPolicy(None, ...)`
fields disable posit for that class.  Serving consumes pre-quantized
weights (`quant.ptq.quantize_for_serving`); `posit_cast` is the forward of
repro's straight-through cast for float weights under a posit policy (the
port has no training path yet, so no gradient rule).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import PositConfig


@dataclasses.dataclass(frozen=True)
class PositPolicy:
    weights: PositConfig | None = None     # linear/embedding storage format
    kv_cache: PositConfig | None = None    # serving KV-cache format
    grads: PositConfig | None = None       # gradient-collective wire format
    activations: PositConfig | None = None # inter-block activation format

    @property
    def enabled(self) -> bool:
        return any((self.weights, self.kv_cache, self.grads, self.activations))


NONE = PositPolicy()


def posit_cast(w: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """f32 -> posit -> f32 round trip: the values posit weights will hold."""
    from repro_torch.kernels import ops
    return ops.decode(ops.encode(w.to(torch.float32), cfg), cfg).to(w.dtype)
