"""Shared helpers of the tests that hold `repro_torch` against `repro`:
the reference params as a numpy tree, and the port's twin of a reference
ModelConfig.  Data crosses between the packages only as numpy."""
from __future__ import annotations

import numpy as np


def numpy_tree(tree):
    """Reference params (dicts/tuples of jax arrays and PositArrays) ->
    the numpy tree `repro_torch.convert.from_repro` takes."""
    from repro.core.array import PositArray
    if isinstance(tree, PositArray):
        return (np.asarray(tree.bits), tree.cfg.n, tree.cfg.es)
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(numpy_tree(v) for v in tree)
    return np.asarray(tree)


def port_posit(cfg):
    """Reference PositConfig (or None) -> the port's."""
    from repro_torch.core.types import PositConfig
    return None if cfg is None else PositConfig(cfg.n, cfg.es)


def port_config(cfg):
    """Reference ModelConfig (dense or MoE attention stacks, rwkv6, or the
    rglru / attn_local hybrid) -> the port's."""
    from repro_torch.models.transformer import ModelConfig, MoEConfig
    from repro_torch.quant.policy import PositPolicy
    assert cfg.tie_embeddings and not cfg.qkv_bias
    assert cfg.norm == "rmsnorm" and cfg.input_mode == "tokens"
    pol = PositPolicy(weights=port_posit(cfg.policy.weights),
                      kv_cache=port_posit(cfg.policy.kv_cache))
    moe = None if cfg.moe is None else MoEConfig(
        n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        capacity_factor=cfg.moe.capacity_factor,
        group_size=cfg.moe.group_size)
    return ModelConfig(name=cfg.name, n_layers=cfg.n_layers,
                       d_model=cfg.d_model, n_heads=cfg.n_heads,
                       n_kv=cfg.n_kv, d_ff=cfg.d_ff, vocab=cfg.vocab,
                       head_dim=cfg.head_dim, act=cfg.act,
                       rope_theta=cfg.rope_theta,
                       block_pattern=tuple(cfg.block_pattern),
                       window=cfg.window, moe=moe,
                       embed_scale=cfg.embed_scale,
                       rwkv_head_dim=cfg.rwkv_head_dim, policy=pol)


def smoke_models(posit: str, ptq: bool = True, arch: str = "smollm-360m"):
    """(reference cfg, reference params, port cfg, port params) for the
    smoke config of `arch` under `posit` in {off, p16, p8}: weights from
    the reference's init_params(PRNGKey(0)), post-training quantized when
    `ptq` (else float weights under the posit policy), carried through
    repro_torch.convert."""
    import jax
    from repro import configs
    from repro.core.types import P8_2, P16_2
    from repro.models.transformer import init_params
    from repro.quant.policy import PositPolicy
    from repro.quant.ptq import quantize_for_serving
    from repro_torch.convert import from_repro

    pcfg = {"p8": P8_2, "p16": P16_2}.get(posit)
    policy = PositPolicy(weights=pcfg, kv_cache=pcfg) if pcfg else PositPolicy()
    cfg = configs.get_smoke(arch, policy=policy)
    params = init_params(jax.random.PRNGKey(0), cfg)
    if pcfg is not None and ptq:
        # jitted: one compile instead of one per eager op, same values
        params = jax.jit(quantize_for_serving, static_argnums=1)(params, pcfg)
    tparams = from_repro(numpy_tree(params), device="cpu")
    return cfg, params, port_config(cfg), tparams


class CopyingJnp:
    """`jax.numpy` whose `asarray` copies numpy inputs first.

    The reference PagedServingEngine passes host numpy arrays that it
    mutates right after dispatch (``self.seq_lens += num_new``, page-table
    edits) to ``jnp.asarray``; on the CPU backend that buffer may alias
    the numpy memory while the jitted step still runs asynchronously, so
    the reference's greedy tokens can vary from run to run.  Installing
    this as ``repro.serving.engine.jnp`` (test-side, with monkeypatch)
    gives each step its own snapshot of the scheduler arrays, which is
    what the engine means; the model math is untouched.
    """

    def __getattr__(self, name):
        import jax.numpy as jnp
        return getattr(jnp, name)

    def asarray(self, x, *args, **kwargs):
        import jax.numpy as jnp
        if isinstance(x, np.ndarray):
            x = np.array(x, copy=True)
        return jnp.asarray(x, *args, **kwargs)
