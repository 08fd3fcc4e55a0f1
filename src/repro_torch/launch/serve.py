"""Serving launcher of the port: posit-quantized paged serving.

    python -m repro_torch.launch.serve --arch smollm-360m --engine paged \
        --batch 8 --prompt-len 512 --max-new 32 --posit p16 --requests 16

``--arch`` is one of smollm-360m, olmoe-1b-7b, rwkv6-3b and
recurrentgemma-9b (recurrent layers keep their state in posit state
pools; recurrentgemma's windowed attention its KV in the paged pool).

Same flags as ``repro/launch/serve.py`` for ``--engine paged``, plus
``--device {cuda,cpu}`` (default cuda).  Weights come from the port's own
seeded init and are post-training quantized (quant/ptq.py); the traffic is
the reference's: `--requests` prompts with lengths drawn from
[prompt-len/4, prompt-len] by numpy seed 1.  A flag whose feature is not
ported yet raises.  The port always serves without the prefix cache, so
``--no-prefix-cache`` is accepted and changes nothing.
"""
from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=["dense", "paged"], default="dense")
    ap.add_argument("--batch", type=int, default=4,
                    help="sequence slots of the paged engine")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--posit", choices=["off", "p8", "p16"], default="p16")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=None,
                    help="total requests to serve (default 2*batch)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="accepted; the port has no prefix cache yet")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL")
    ap.add_argument("--host-devices", type=int, default=None)
    ap.add_argument("--max-waiting", type=int, default=None)
    ap.add_argument("--ttl-steps", type=int, default=None)
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--chaos", default=None, metavar="KIND=P[,KIND=P...]")
    ap.add_argument("--chaos-seed", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def _reject_unported(args) -> None:
    unported = {"--engine dense": args.engine != "paged",
                "--ckpt-dir": args.ckpt_dir is not None,
                "--temperature > 0": args.temperature > 0.0,
                "--mesh": args.mesh is not None,
                "--host-devices": args.host_devices is not None,
                "--max-waiting": args.max_waiting is not None,
                "--ttl-steps": args.ttl_steps is not None,
                "--deadline-s": args.deadline_s is not None,
                "--chaos": args.chaos is not None,
                "--chaos-seed": args.chaos_seed is not None}
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"not ported yet: {', '.join(asked)} "
                                  f"(use --engine paged)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _reject_unported(args)

    import numpy as np
    from repro_torch import configs
    from repro_torch.core.types import P8_2, P16_2
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.quant.policy import PositPolicy
    from repro_torch.quant.ptq import quantize_for_serving
    from repro_torch.serving.engine import OUTCOMES, PagedServingEngine

    pcfg = {"p8": P8_2, "p16": P16_2}.get(args.posit)
    policy = PositPolicy(weights=pcfg, kv_cache=pcfg) if pcfg else PositPolicy()
    get = configs.get_smoke if args.smoke else configs.get_config
    cfg = get(args.arch, policy=policy)

    params = init_params(cfg, seed=0, device=args.device)
    if pcfg is not None:
        params = quantize_for_serving(params, pcfg)
        print(f"[serve] PTQ {pcfg}: weights now "
              f"{_param_bytes(params) / 1e6:.1f} MB")

    n_req = args.requests or 2 * args.batch
    rng = np.random.default_rng(1)
    cap = args.prompt_len + args.max_new
    width = max(2, -(-cap // args.page_size))
    from repro_torch.serving.backends import layout_for
    layout = layout_for(cfg)
    kinds = ",".join(f"{b.kind}:{b.backend}" for b in layout.backends)
    print(f"[serve] cache backends: {kinds}; per-seq cache at "
          f"{cap} tokens = "
          f"{layout.cache_bytes_per_seq(cap, args.page_size) / 1e3:.1f} KB")
    eng = PagedServingEngine(params, cfg, max_seqs=args.batch,
                             page_size=args.page_size, table_width=width,
                             prefill_chunk=args.prefill_chunk,
                             device=args.device)
    reqs = []
    for _ in range(n_req):
        plen = int(rng.integers(max(1, args.prompt_len // 4),
                                args.prompt_len + 1))
        reqs.append((rng.integers(0, cfg.vocab, plen), args.max_new))
    t0 = time.time()
    results = eng.run(reqs)
    dt = time.time() - t0
    n_tok = sum(len(v) for v in results.values())
    stats = eng.stats()
    print(f"[serve] paged on {eng.device}: {len(results)} requests, {n_tok} "
          f"tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s); stats={stats}")
    print("[serve] outcomes: " + " ".join(f"{k}={stats.get(k, 0)}"
                                          for k in OUTCOMES))
    print(f"[serve] kernel launches: {ops.launch_counts()}")
    for rid in sorted(results):
        print(f"[serve] rid {rid}: {results[rid].tolist()}")


def _param_bytes(tree) -> int:
    import torch
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_param_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return tree.nbytes


if __name__ == "__main__":
    main()
