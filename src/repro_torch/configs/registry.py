"""Architecture registry: ``--arch <id>`` resolves here.

Counterpart of ``repro/configs/registry.py``: the same ids, each resolved to
the port's own config module (``batann-serve`` to the port's
``configs/batann_serve.py``).
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen2-0.5b",
    "qwen3-14b",
    "qwen1.5-0.5b",
    "gemma3-27b",
    "mamba2-130m",
    "kimi-k2-1t-a32b",
    "grok-1-314b",
    "hymba-1.5b",
    "musicgen-large",
    "internvl2-2b",
    "batann-serve",          # the paper's own workload as a config
]

_MODULES = {i: "repro_torch.configs." + i.replace("-", "_").replace(".", "_")
            for i in ARCH_IDS}


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str):
    """Reduced same-family config for CPU smoke tests."""
    return importlib.import_module(_MODULES[arch_id]).smoke_config()


# --- the service layer's serve configs (deployment scenarios, not LM archs) --


def serve_config_ids() -> list[str]:
    from repro_torch.configs.batann_serve import SERVE_CONFIGS

    return sorted(SERVE_CONFIGS)


def get_serve_config(name: str):
    """``--config <name>`` of the serve launcher resolves here: a named
    :class:`repro_torch.configs.batann_serve.ServeConfig` preset."""
    from repro_torch.configs.batann_serve import SERVE_CONFIGS

    if name not in SERVE_CONFIGS:
        raise KeyError(
            f"unknown serve config '{name}'; known: {sorted(SERVE_CONFIGS)}")
    return SERVE_CONFIGS[name]
