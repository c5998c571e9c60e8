"""Transformer blocks (reference: ``repro/models/blocks.py``), the kinds
the ported models use:

  attn       pre-norm GQA self-attention + a SwiGLU, GeGLU or GELU FFN
  local      the same with sliding-window attention (``cfg.sliding_window``)
  moe        GQA self-attention + the top-k MoE FFN (``models/moe.py``)
  local_moe  sliding-window attention + the MoE FFN
  enc        bidirectional self-attention + FFN (an encoder's)
  dec        causal self-attention + cross-attention to the encoder's
             output (``lnx`` + ``xattn``, with its own adapters) + FFN
  mamba      the Mamba2 SSD mixer (``models/ssm.py``) after ``ln1``, one
             residual branch (training only)
  shared_attn  Zamba2's shared block: an ``attn`` block's params and
             adapters, one set that ``models/lm.py`` passes in at every
             occurrence (``dec.shared``); it runs as ``local`` when the
             config has a sliding window and as ``attn`` otherwise
             (training only)

Self-attention is causal unless the block is an encoder's or the config is
bidirectional: ``causal = (kind != "enc") and cfg.causal``.  Under the
bottleneck PEFT kinds (FedAdapter-H/P) a bottleneck adapter follows the MLP
output and, for ``adapter_h``, the self-attention output, each before its
residual; a ``mamba`` block gets only the MLP's, and, as the reference
has it, applied to the residual stream after the mixer's residual.  With
``cfg.post_block_norm`` (Gemma) the attention and MLP
outputs are normed again (``pn1``, ``pn2``) before their residuals."""

from __future__ import annotations

from repro_torch.core import adapters as AD
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import mlp as MLP
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

LORA_KINDS = (AD.BEA, AD.LORA, AD.FFA)
BOTTLENECK_KINDS = ("adapter_h", "adapter_p")
KINDS = ("attn", "local", "moe", "local_moe", "enc", "dec", "mamba",
         "shared_attn")


def is_moe(kind: str) -> bool:
    return kind in ("moe", "local_moe")


def _require_ported(cfg, kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet; see ROADMAP.md queue 1 "
            f"item 12")


def block_meta(cfg, kind: str) -> dict:
    _require_ported(cfg, kind)
    if kind == "shared_attn":       # one set, reused at every occurrence
        kind = "attn"
    if kind == "mamba":
        return {"ln1": L.norm_meta(cfg), "ssm": SSM.ssm_meta(cfg)}
    m = {"ln1": L.norm_meta(cfg), "attn": ATT.attn_meta(cfg),
         "ln2": L.norm_meta(cfg)}
    if kind == "dec":
        m["lnx"] = L.norm_meta(cfg)
        m["xattn"] = ATT.attn_meta(cfg, cross=True)
    if is_moe(kind):
        m["moe"] = MOE.moe_meta(cfg)
    else:
        m["mlp"] = MLP.mlp_meta(cfg)
    if cfg.post_block_norm:
        m["pn1"] = L.norm_meta(cfg)
        m["pn2"] = L.norm_meta(cfg)
    return m


def block_adapter_meta(cfg, kind: str, peft: str) -> dict:
    """Trainable-tree structure for one block under a PEFT strategy."""
    _require_ported(cfg, kind)
    if kind == "shared_attn":
        kind = "attn"
    if peft in ("none", "fft"):
        return {}
    if peft in BOTTLENECK_KINDS:
        size = cfg.adapter_rank * 2        # bottleneck sized ~2r (paper §V)
        out = {"post_mlp": AD.bottleneck_meta(cfg.d_model, size)}
        if peft == "adapter_h" and kind != "mamba":
            out["post_attn"] = AD.bottleneck_meta(cfg.d_model, size)
        return out
    if peft not in LORA_KINDS:
        raise NotImplementedError(f"peft {peft!r} is not ported yet")
    if kind == "mamba":
        return {"ssm": SSM.ssm_adapter_meta(cfg, peft)}
    out = {"attn": ATT.attn_adapter_meta(cfg, peft)}
    if kind == "dec":
        out["xattn"] = ATT.attn_adapter_meta(cfg, peft)
    if is_moe(kind):
        out["moe"] = MOE.moe_adapter_meta(cfg, peft)
    else:
        out["mlp"] = MLP.mlp_adapter_meta(cfg, peft)
    return {k: v for k, v in out.items() if v}


def block_cache_meta(cfg, kind: str, batch: int, seq: int,
                     src_len: int = 0) -> dict:
    """An ``attn`` block's KV cache {"k", "v"}; a ``dec`` block's
    ``attn_cache`` (its self-attention's, ``seq`` positions) and
    ``xattn_cache`` (the encoder's k/v, ``src_len`` positions; reference
    ``blocks.py:75-86``)."""
    if kind not in ("attn", "dec"):
        raise NotImplementedError(
            f"a {kind!r} block's cache is not ported yet (ROADMAP.md queue 1 "
            f"item 13)")
    _require_ported(cfg, kind)
    if kind == "dec":
        return {"attn_cache": ATT.cache_meta(cfg, batch, seq),
                "xattn_cache": ATT.cross_cache_meta(cfg, batch, src_len)}
    return ATT.cache_meta(cfg, batch, seq)


def block_apply(p: dict, x, cfg, *, mode: str, kind: str = "attn", ad=None,
                masks=None, cache=None, idx=None, rows=None, pos=None,
                use_kernel: bool = False, clients: bool = False,
                enc_out=None, route=None, record=None):
    """Returns (x, aux, new_cache), ``aux`` the MoE router's load-balance
    loss (0.0 for the other kinds; a ``mamba`` block trains only, its
    cache None).  ``clients``: x is (C, B, S, d) and
    every adapter leaf has a leading C (the cohort's local phase).  A
    ``dec`` block cross-attends to ``enc_out`` (B, Se, d) in training and
    prefill, and in decode to the k/v that prefill left in its cache's
    ``xattn_cache`` (its self-attention's in ``attn_cache``); a ``local``
    block's attention is windowed, and so is a ``shared_attn`` block's
    when the config has a sliding window (``p``, ``ad`` and ``masks`` are
    then the shared set).  ``route`` and ``record`` reach an MoE block's
    ``moe_apply``."""
    ad = ad or {}
    masks = masks or {}
    if clients and (is_moe(kind) or kind in ("mamba", "shared_attn")):
        raise NotImplementedError(
            f"the cohort's client-batched forward over a {kind!r} block is "
            f"not ported: the reference's runners train no MoE, SSM or "
            f"hybrid model (see ROADMAP.md queue 1 item 12)")
    if kind == "shared_attn":
        if mode != "train":
            raise NotImplementedError(
                f"a shared_attn block's {mode} (a KV cache per occurrence) "
                f"is not ported yet; see ROADMAP.md queue 1 item 13")
        kind = "local" if cfg.sliding_window else "attn"
    if kind == "mamba":
        h = SSM.ssm_apply(p["ssm"], L.norm_apply(p["ln1"], x, cfg), cfg,
                          mode=mode, ad=ad.get("ssm"), masks=masks.get("ssm"),
                          use_kernel=use_kernel)
        x = x + h
        if "post_mlp" in ad:        # on the stream, after the residual
            x = AD.apply_bottleneck(x, ad["post_mlp"])
        return x, 0.0, None
    kw = dict(use_kernel=use_kernel, clients=clients)
    window = cfg.sliding_window if kind.startswith("local") else 0
    dec_cache = kind == "dec" and cache is not None
    h, new_cache = ATT.attention(
        p["attn"], L.norm_apply(p["ln1"], x, cfg), cfg, mode=mode,
        ad=ad.get("attn"), masks=masks.get("attn"),
        cache=cache["attn_cache"] if dec_cache else cache, idx=idx,
        rows=rows, pos=pos, causal=(kind != "enc") and cfg.causal,
        window=window, **kw)
    if "pn1" in p:
        h = L.norm_apply(p["pn1"], h, cfg)
    if "post_attn" in ad:
        h = AD.apply_bottleneck(h, ad["post_attn"], clients=clients)
    x = x + h
    if kind == "dec" and (enc_out is not None or dec_cache):
        h, x_cache = ATT.attention(
            p["xattn"], L.norm_apply(p["lnx"], x, cfg), cfg, mode=mode,
            ad=ad.get("xattn"), masks=masks.get("xattn"), kv_x=enc_out,
            cache=cache["xattn_cache"] if dec_cache else None, idx=idx,
            rows=rows, cross=True, causal=False, **kw)
        x = x + h
        if dec_cache:
            new_cache = {"attn_cache": new_cache, "xattn_cache": x_cache}
    aux = 0.0
    h2 = L.norm_apply(p["ln2"], x, cfg)
    if is_moe(kind):
        h2, aux = MOE.moe_apply(p["moe"], h2, cfg, ad=ad.get("moe"),
                                masks=masks.get("moe"), route=route,
                                record=record)
    else:
        h2 = MLP.mlp_apply(p["mlp"], h2, cfg, ad=ad.get("mlp"),
                           masks=masks.get("mlp"), idx=idx, **kw)
    if "pn2" in p:
        h2 = L.norm_apply(p["pn2"], h2, cfg)
    if "post_mlp" in ad:
        h2 = AD.apply_bottleneck(h2, ad["post_mlp"], clients=clients)
    return x + h2, aux, new_cache
