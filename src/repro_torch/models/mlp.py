"""Feed-forward blocks (reference: ``repro/models/mlp.py``): gated SwiGLU
``silu(w1·x) ⊙ (w3·x)`` then ``w2``, or plain GELU ``gelu(w1·x)`` then
``w2``, with adapters on every linear."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.core import adapters as AD
from repro_torch.models import layers as L


def mlp_meta(cfg) -> dict:
    if cfg.act not in ("silu", "gelu"):
        raise NotImplementedError(f"activation {cfg.act!r} is not ported yet")
    m = {"w1": L.dense_meta(cfg, cfg.d_model, cfg.d_ff)}
    if cfg.glu:
        m["w3"] = L.dense_meta(cfg, cfg.d_model, cfg.d_ff)
    m["w2"] = L.dense_meta(cfg, cfg.d_ff, cfg.d_model, out_scale=0.05)
    return m


def mlp_adapter_meta(cfg, kind: str) -> dict:
    out = {}
    for name, (di, do) in (("w1", (cfg.d_model, cfg.d_ff)),
                           ("w3", (cfg.d_model, cfg.d_ff)),
                           ("w2", (cfg.d_ff, cfg.d_model))):
        if name == "w3" and not cfg.glu:
            continue
        if name in cfg.adapter_targets:
            ad = AD.adapter_meta(kind, di, do, cfg.adapter_rank)
            if ad is not None:
                out[name] = ad
    return out


def activation(h, cfg):
    # jax.nn.gelu defaults to the tanh form
    return F.silu(h) if cfg.act == "silu" else F.gelu(h, approximate="tanh")


def mlp_apply(p: dict, x, cfg, ad=None, masks=None, *, idx=None,
              use_kernel: bool = False, clients: bool = False):
    ad = ad or {}
    masks = masks or {}
    scaling = cfg.adapter_alpha / max(cfg.adapter_rank, 1)
    kw = dict(idx=idx, use_kernel=use_kernel, clients=clients)
    h = L.dense_apply(p["w1"], x, ad.get("w1"), masks.get("w1"), scaling, **kw)
    h = activation(h, cfg)
    if cfg.glu:
        h = h * L.dense_apply(p["w3"], x, ad.get("w3"), masks.get("w3"),
                              scaling, **kw)
    return L.dense_apply(p["w2"], h, ad.get("w2"), masks.get("w2"), scaling,
                         **kw)
