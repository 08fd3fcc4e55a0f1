"""Architecture registry of the port: get_config(name) -> full ModelConfig;
get_smoke(name) -> the reduced same-family config for CPU tests."""
from repro_torch.configs import (olmoe_1b_7b, recurrentgemma_9b, rwkv6_3b,
                                 smollm_360m)

_MODULES = {
    "smollm-360m": smollm_360m,
    "olmoe-1b-7b": olmoe_1b_7b,
    "rwkv6-3b": rwkv6_3b,
    "recurrentgemma-9b": recurrentgemma_9b,
}

ARCHS = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise NotImplementedError(f"arch {name!r} is not ported yet; "
                                  f"ported: {ARCHS}")
    return _MODULES[name]


def get_config(name: str, **overrides):
    return _module(name).full(**overrides)


def get_smoke(name: str, **overrides):
    return _module(name).smoke(**overrides)
