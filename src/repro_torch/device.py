"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` -> torch.device, raising when CUDA is asked for and absent.

    There is no silent fallback: the CPU runs only when the caller names it.
    On CUDA, float32 matmuls and convolutions are pinned to full float32
    (TF32 off), because the reference accumulates exact posit decodes in f32.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available; pass device='cpu' to run the "
                               "plain PyTorch versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
