"""Deterministic, seekable synthetic token pipeline.

The counterpart of ``repro/data/pipeline.py``, with its contract: the
batch of a step is a pure function of (seed, step, shape), with no
iterator state, so a resumed run regenerates exactly the batches it
would have seen, and per-host slices tile the global batch for any host
count.  Sequences follow per-sequence affine recurrences x_{t+1} = a x_t
+ b mod V, with a share of tokens replaced by noise.  The numbers come
from a CPU `torch.Generator` seeded from (seed, step) and are then moved
to the device, so the card and the CPU see the same batch (they are not
the reference's threefry numbers).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05


def _generator(seed: int, step: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def global_batch_at(step: int, cfg: DataConfig, *, device="cuda"):
    """{"tokens": [global_batch, seq_len + 1] int32}: inputs are
    [:, :-1], labels [:, 1:]."""
    dev = resolve_device(device)
    gen = _generator(cfg.seed, step)
    Bsz, S, V = cfg.global_batch, cfg.seq_len + 1, cfg.vocab
    a = torch.randint(1, 64, (Bsz,), generator=gen)
    b = torch.randint(0, V, (Bsz,), generator=gen)
    x = torch.randint(0, V, (Bsz,), generator=gen)
    toks = torch.empty((Bsz, S), dtype=torch.int64)
    for t in range(S):
        x = (a * x + b) % V
        toks[:, t] = x
    noise = torch.rand((Bsz, S), generator=gen) < cfg.noise
    noise_tok = torch.randint(0, V, (Bsz, S), generator=gen)
    toks = torch.where(noise, noise_tok, toks).to(torch.int32)
    return {"tokens": toks.to(dev)}


def host_row_bounds(global_batch: int, host_id: int, num_hosts: int):
    """[lo, hi) rows of the global batch owned by `host_id`: the first
    global_batch % num_hosts hosts take one extra row, so the slices tile
    the whole batch in host order for any host count."""
    if not 1 <= num_hosts:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} outside [0, {num_hosts})")
    base, rem = divmod(global_batch, num_hosts)
    lo = host_id * base + min(host_id, rem)
    return lo, lo + base + (1 if host_id < rem else 0)


def host_batch_at(step: int, cfg: DataConfig, host_id: int, num_hosts: int,
                  *, device="cuda"):
    """Host `host_id`'s slice of global_batch_at(step): the slices of hosts
    0..num_hosts-1 concatenate to the global batch, for any num_hosts."""
    full = global_batch_at(step, cfg, device=device)
    lo, hi = host_row_bounds(cfg.global_batch, host_id, num_hosts)
    return {k: v[lo:hi] for k, v in full.items()}
