"""Training launcher of the port, on one device.

    python -m repro_torch.launch.train --arch smollm-360m --steps 8 \\
        --seq-len 512 --global-batch 8 --posit p16

runs posit16-QAT training of full-width smollm-360m on the GPU (the
default device); ``--smoke --device cpu`` runs the reduced config on the
CPU through the plain versions of every kernel.  The sharding, elastic
and supervisor flags of ``repro.launch.train`` are parsed and raise "not
ported yet".
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--posit", choices=["off", "p8", "p16"], default="p16")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    # flags of the reference launcher whose machinery is not ported
    for flag, kind in (("--dp", int), ("--tp", int), ("--workers", int),
                       ("--host-devices", int), ("--step-timeout", float)):
        ap.add_argument(flag, type=kind, default=None)
    for flag in ("--restart-on-failure", "--async-ckpt"):
        ap.add_argument(flag, action="store_true")
    args = ap.parse_args(argv)

    unported = [f for f, v in (("--dp", args.dp not in (None, 1)),
                               ("--tp", args.tp not in (None, 1)),
                               ("--workers", args.workers not in (None, 1)),
                               ("--host-devices", args.host_devices),
                               ("--step-timeout", args.step_timeout),
                               ("--restart-on-failure",
                                args.restart_on_failure),
                               ("--async-ckpt", args.async_ckpt)) if v]
    if unported:
        raise NotImplementedError(f"{', '.join(unported)}: not ported yet "
                                  f"(the port trains on one device)")

    from repro_torch import configs
    from repro_torch.core.types import P8_2, P16_2
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.device import resolve_device
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.quant.policy import PositPolicy
    from repro_torch.training.trainer import RestartPolicy, train_loop

    dev = resolve_device(args.device)
    policy = {"off": PositPolicy(),
              "p8": PositPolicy(weights=P8_2),
              "p16": PositPolicy(weights=P16_2)}[args.posit]
    get = configs.get_smoke if args.smoke else configs.get_config
    cfg = get(args.arch, policy=policy)
    opt_cfg = OptConfig(lr_peak=args.lr,
                        warmup_steps=min(100, args.steps // 10 + 1),
                        total_steps=args.steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                          global_batch=args.global_batch)
    _, _, hist = train_loop(cfg, opt_cfg, data_cfg, args.steps,
                            ckpt_dir=args.ckpt_dir,
                            policy=RestartPolicy(ckpt_every=args.ckpt_every),
                            accum_steps=args.accum_steps, seed=args.seed,
                            device=dev)
    last = hist[-1]
    print(f"[launch] {cfg.name} posit={args.posit} on {dev}: {args.steps} "
          f"steps, final loss {last['loss']:.4f}")


if __name__ == "__main__":
    main()
