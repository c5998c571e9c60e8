"""Config registry (reference: ``repro/configs/__init__.py``).

Ported: the vision-prefixed InternVL2-1B, Qwen2-0.5B, Gemma2-2B,
Gemma3-1B, MiniCPM-2B, the MoE models Granite-3.0-1B-A400M and Kimi-K2,
the SSM Mamba2-780M and the hybrid Zamba2-1.2B among the assigned
architectures (``ARCH_IDS``), and the paper's own models DistilBERT, BERT
and BART (``PAPER_IDS``).  Every other architecture (SeamlessM4T-large-v2)
raises and points at the ROADMAP queue that ports it.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig  # noqa: F401

ARCH_IDS = ["internvl2_1b", "zamba2_1p2b", "kimi_k2_1t_a32b", "gemma2_2b",
            "gemma3_1b", "minicpm_2b", "qwen2_0p5b", "mamba2_780m",
            "granite_moe_1b_a400m"]
PAPER_IDS = ["distilbert", "bert", "bart"]

_ALIASES = {"internvl2-1b": "internvl2_1b", "zamba2-1.2b": "zamba2_1p2b",
            "kimi-k2-1t-a32b": "kimi_k2_1t_a32b", "gemma2-2b": "gemma2_2b",
            "gemma3-1b": "gemma3_1b", "minicpm-2b": "minicpm_2b",
            "qwen2-0.5b": "qwen2_0p5b", "mamba2-780m": "mamba2_780m",
            "granite-moe-1b-a400m": "granite_moe_1b_a400m"}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS + PAPER_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; see ROADMAP.md "
            f"queue 1 item 12 ('then the other architectures')")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG
