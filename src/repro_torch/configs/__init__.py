"""Architecture configs: one module per assigned architecture.

`get(name)` returns the full published config; `get(name, reduced=True)`
returns the smoke-test reduction of the same family (few layers, narrow,
tiny vocab) used by per-arch CPU smoke tests.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeSpec  # noqa: F401 — re-exported config vocabulary

_ARCH_MODULES = (
    "deepseek_moe_16b",
    "deepseek_v3_671b",
    "tinyllama_1_1b",
    "qwen3_14b",
    "gemma_7b",
    "minicpm_2b",
    "hymba_1_5b",
    "whisper_small",
    "rwkv6_3b",
    "chameleon_34b",
)

ARCH_IDS = tuple(m.replace("_", "-").replace("-1-1b", "-1.1b")
                 .replace("-1-5b", "-1.5b") for m in _ARCH_MODULES)


def _module_for(name: str):
    import importlib
    mod = name.replace("-", "_").replace("1.1b", "1_1b").replace("1.5b", "1_5b")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str, reduced: bool = False) -> ArchConfig:
    m = _module_for(name)
    return m.reduced_config() if reduced else m.config()


def all_archs() -> tuple[str, ...]:
    return ARCH_IDS
