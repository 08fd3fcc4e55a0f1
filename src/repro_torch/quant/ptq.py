"""Post-training quantization to posit storage (serving deployment).

Same leaf selection as ``repro/quant/ptq.py:18-24``: linear weight
matrices and embedding tables quantize; norms and biases stay f32.  The
encode runs through the codec kernel on CUDA.
"""
from __future__ import annotations

import re

import torch

from repro_torch.core.array import PositArray
from repro_torch.core.types import PositConfig

_QUANT_PATTERNS = [
    r"embed/table$",
    r"unembed/w$",
    r"moe/w_(up|gate|down)$",
    r"(wq|wk|wv|wg|wo|wr|w_up|w_gate|w_down|w_x|w_gate_branch|"
    r"w_input_gate|w_rec_gate|w_out)/w$",
]
_QUANT_RE = [re.compile(p) for p in _QUANT_PATTERNS]


def is_quantizable(path_str: str) -> bool:
    return any(p.search(path_str) for p in _QUANT_RE)


def quantize_for_serving(params, cfg: PositConfig):
    """Nested dict/list/tuple of f32 tensors -> same tree with PositArray
    on the quantizable leaves (path components joined by "/")."""
    from repro_torch.kernels import ops

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
            return type(node)(out)
        if (isinstance(node, torch.Tensor) and node.is_floating_point()
                and is_quantizable(path)):
            return PositArray(ops.encode(node, cfg), cfg)
        return node

    return walk(params, "")
