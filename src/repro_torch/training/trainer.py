"""Training loop with checkpoint/restart.

The counterpart of ``repro/training/trainer.py`` on one device: seeded
init (or a resume from the newest valid checkpoint in `ckpt_dir`), the
step from `make_train_step`, a log line every `log_every` steps with
steps/s, checkpoints every `policy.ckpt_every` steps and at the end.  In
place of the reference's fallback counters, each log line carries the
deltas of `kernels.ops.plain_counts()`: off the CPU a plain call
raises, so a run on the card is a run on the kernels.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.checkpoint import store
from repro_torch.data.pipeline import DataConfig, global_batch_at
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.transformer import ModelConfig, init_params
from repro_torch.optim import adamw
from repro_torch.training.train_step import make_train_step


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """The checkpoint knobs of ``repro.distributed.fault_tolerance.
    RestartPolicy``; the watchdog and the supervisor's restart knobs are
    not ported."""
    ckpt_every: int = 50
    keep: int = 3


def _counter_delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def train_loop(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
               data_cfg: DataConfig, num_steps: int,
               ckpt_dir: str | None = None,
               policy: RestartPolicy = RestartPolicy(), log_every: int = 10,
               seed: int = 0, verbose: bool = True, mesh=None,
               accum_steps: int = 1, chaos_nar_steps=None,
               async_ckpt: bool = False, device="cuda"):
    """Runs (or resumes) training from init_params(cfg, seed) on `device`;
    returns (params, opt_state, history).  The sharded mesh, chaos NaR
    injection and the async checkpoint store are not ported yet and
    raise.
    """
    if mesh is not None:
        raise NotImplementedError("train_loop: mesh training is not ported "
                                  "yet")
    if chaos_nar_steps is not None:
        raise NotImplementedError("train_loop: chaos NaR injection is not "
                                  "ported yet")
    if async_ckpt:
        raise NotImplementedError("train_loop: the async checkpoint store is "
                                  "not ported yet")
    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, device=dev)
    opt_state = adamw.init_state(params, opt_cfg)
    start_step = 0
    if ckpt_dir:
        step, restored = store.restore_latest(
            ckpt_dir, {"params": params, "opt": opt_state})
        if step is not None:
            params, opt_state = restored["params"], restored["opt"]
            start_step = step
            if verbose:
                print(f"[trainer] resumed from step {step}")

    step_fn = make_train_step(cfg, opt_cfg, accum_steps=accum_steps,
                              device=dev)

    def _save(at_step):
        store.save(ckpt_dir, at_step, {"params": params, "opt": opt_state},
                   keep=policy.keep)

    history = []
    t0 = time.time()
    t_log, s_log = t0, start_step
    ctr_log = ops.plain_counts()
    for step in range(start_step, num_steps):
        batch = global_batch_at(step, data_cfg, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == num_steps - 1:
            # float() waits for the step: steps/s counts finished work
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            now = time.time()
            m["wall_s"] = now - t0
            m["steps_per_s"] = (step + 1 - s_log) / max(now - t_log, 1e-9)
            ctr = ops.plain_counts()
            m["plain_calls"] = _counter_delta(ctr_log, ctr)
            if m["plain_calls"] and dev.type != "cpu":
                raise RuntimeError(f"train_loop: plain versions ran on "
                                   f"{dev}: {m['plain_calls']}")
            t_log, s_log, ctr_log = now, step + 1, ctr
            history.append(m)
            if verbose:
                nar = (f" nar_skips {int(m['nar_skips'])}"
                       if m.get("nar_skips") else "")
                print(f"[trainer] step {step:5d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                      f"{m['steps_per_s']:.2f} steps/s{nar}")
        if ckpt_dir and (step + 1) % policy.ckpt_every == 0:
            _save(step + 1)
    if ckpt_dir:
        _save(num_steps)
    return params, opt_state, history
