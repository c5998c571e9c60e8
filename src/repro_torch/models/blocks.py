"""Transformer blocks (reference: ``repro/models/blocks.py``), the ``attn``
kind only: pre-norm GQA attention (causal unless the config is an encoder's,
as ``causal = (kind != "enc") and cfg.causal`` gives for this kind) + a
SwiGLU or GELU FFN.  Under the bottleneck PEFT kinds (FedAdapter-H/P) a
bottleneck adapter follows the MLP output and, for ``adapter_h``, the
attention output, each before its residual."""

from __future__ import annotations

from repro_torch.core import adapters as AD
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import mlp as MLP

LORA_KINDS = (AD.BEA, AD.LORA, AD.FFA)
BOTTLENECK_KINDS = ("adapter_h", "adapter_p")


def _require_attn(cfg, kind: str) -> None:
    if kind != "attn" or cfg.post_block_norm:
        raise NotImplementedError(
            f"block kind {kind!r} (post_block_norm={cfg.post_block_norm}) is "
            f"not ported yet; see ROADMAP.md queue 1")


def block_meta(cfg, kind: str) -> dict:
    _require_attn(cfg, kind)
    return {"ln1": L.norm_meta(cfg), "attn": ATT.attn_meta(cfg),
            "ln2": L.norm_meta(cfg), "mlp": MLP.mlp_meta(cfg)}


def block_adapter_meta(cfg, kind: str, peft: str) -> dict:
    """Trainable-tree structure for one block under a PEFT strategy."""
    _require_attn(cfg, kind)
    if peft in ("none", "fft"):
        return {}
    if peft in BOTTLENECK_KINDS:
        size = cfg.adapter_rank * 2        # bottleneck sized ~2r (paper §V)
        out = {"post_mlp": AD.bottleneck_meta(cfg.d_model, size)}
        if peft == "adapter_h":
            out["post_attn"] = AD.bottleneck_meta(cfg.d_model, size)
        return out
    if peft not in LORA_KINDS:
        raise NotImplementedError(f"peft {peft!r} is not ported yet")
    out = {"attn": ATT.attn_adapter_meta(cfg, peft),
           "mlp": MLP.mlp_adapter_meta(cfg, peft)}
    return {k: v for k, v in out.items() if v}


def block_cache_meta(cfg, kind: str, batch: int, seq: int) -> dict:
    _require_attn(cfg, kind)
    return ATT.cache_meta(cfg, batch, seq)


def block_apply(p: dict, x, cfg, *, mode: str, ad=None, masks=None,
                cache=None, idx=None, rows=None, pos=None,
                use_kernel: bool = False, clients: bool = False):
    """Returns (x, new_cache).  ``clients``: x is (C, B, S, d) and every
    adapter leaf has a leading C (the cohort's local phase)."""
    ad = ad or {}
    masks = masks or {}
    h, new_cache = ATT.attention(
        p["attn"], L.norm_apply(p["ln1"], x, cfg), cfg, mode=mode,
        ad=ad.get("attn"), masks=masks.get("attn"), cache=cache, idx=idx,
        rows=rows, pos=pos, use_kernel=use_kernel, clients=clients)
    if "post_attn" in ad:
        h = AD.apply_bottleneck(h, ad["post_attn"], clients=clients)
    x = x + h
    h2 = MLP.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], x, cfg), cfg,
                       ad=ad.get("mlp"), masks=masks.get("mlp"), idx=idx,
                       use_kernel=use_kernel, clients=clients)
    if "post_mlp" in ad:
        h2 = AD.apply_bottleneck(h2, ad["post_mlp"], clients=clients)
    return x + h2, new_cache
