"""Config registry (reference: ``repro/configs/__init__.py``).

Three models are ported: Qwen2-0.5B (the serving slice), DistilBERT (the
training slice) and BERT (the baselines' second classifier); every other
architecture raises and points at the ROADMAP queue that ports it.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig  # noqa: F401

ARCH_IDS = ["qwen2_0p5b", "distilbert", "bert"]

_ALIASES = {"qwen2-0.5b": "qwen2_0p5b"}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; see ROADMAP.md "
            f"queue 1 ('Other architectures')")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG
