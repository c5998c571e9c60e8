"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060] (reference:
``repro/models/ssm.py``), training mode.

The paper's adapters attach to in_proj ("f1") and out_proj ("f2"), which
run through the same adapted linear as every other block
(``layers.dense_apply``: the ``bea_dense`` kernel on the card under
``use_kernel``, its plain version on the CPU).  The SSD core is plain
torch, as the reference's is jnp: no TPU kernel stands behind it.  Serving
(``ssm_cache_meta``, prefill's final state, the decode recurrence) is
ROADMAP.md queue 1 item 13's and refuses here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import adapters as AD
from repro_torch.models import layers as L
from repro_torch.pytree import ParamMeta


def _dims(cfg):
    d_inner = cfg.d_inner
    n = cfg.ssm_state
    return d_inner, cfg.ssm_heads, n, d_inner + 2 * n   # x, B, C share the conv


def ssm_meta(cfg) -> dict:
    d_inner, h, n, conv_dim = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_inner + 2 * n + h   # [z, x, B, C, dt]
    return {
        "in_proj": {"w": ParamMeta((d, proj_out), cfg.pdtype, init="normal")},
        "conv_w": ParamMeta((cfg.ssm_conv, conv_dim), cfg.pdtype,
                            init="normal", scale=0.5),
        "conv_b": ParamMeta((conv_dim,), cfg.pdtype, init="zeros"),
        "a_log": ParamMeta((h,), torch.float32, init="ones"),
        "dt_bias": ParamMeta((h,), torch.float32, init="zeros"),
        "d_skip": ParamMeta((h,), torch.float32, init="ones"),
        "gate_norm": {"scale": ParamMeta((d_inner,), torch.float32,
                                         init="ones")},
        "out_proj": {"w": ParamMeta((d_inner, d), cfg.pdtype, init="normal",
                                    scale=0.05)},
    }


def ssm_adapter_meta(cfg, kind: str) -> dict:
    d_inner, h, n, _ = _dims(cfg)
    proj_out = 2 * d_inner + 2 * n + h
    out = {}
    if "w1" in cfg.adapter_targets:     # in_proj plays the "f1" role
        ad = AD.adapter_meta(kind, cfg.d_model, proj_out, cfg.adapter_rank)
        if ad is not None:
            out["in_proj"] = ad
    if "w2" in cfg.adapter_targets:     # out_proj plays the "f2" role
        ad = AD.adapter_meta(kind, d_inner, cfg.d_model, cfg.adapter_rank)
        if ad is not None:
            out["out_proj"] = ad
    return out


def _split(proj: torch.Tensor, cfg):
    """in_proj's output → (z, x, B, C, dt) along the last axis."""
    d_inner, h, n, _ = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner, n, n, h], dim=-1)


def _conv_causal(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of kernel K, then SiLU, in x's dtype.  x:
    (B, S, C); w: (K, C); b: (C,).  The K taps summed in the reference's
    order."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(k))
    return F.silu(y + b.to(x.dtype))


def _gated_norm(p: dict, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = y * F.silu(z)
    yf = y.float()
    yn = yf * torch.rsqrt(yf.pow(2).mean(-1, keepdim=True) + 1e-6)
    return (yn * p["scale"]).to(y.dtype)


def ssd_chunked(x, dt, a, b, c, chunk: int):
    """SSD scan.  x: (B, S, H, P), dt: (B, S, H) f32, a: (H,) < 0, b, c:
    (B, S, N).  Returns y (B, S, H, P) in x's dtype and the final state
    (B, H, P, N) in f32.

    Within a chunk, y_i = Σ_{j ≤ i} (c_i·b_j) exp(cum_i − cum_j) dt_j x_j
    (cum the running sum of dt·a); across chunks a state carried by a loop
    over the chunks.  The (L, L) decay is built per head in (B, nc, H, L, L)
    layout, multiplied by c·b, and contracted with dt·x by one batched
    product over j, so no (L, L, H, P) intermediate exists: at Mamba2-780M's
    width (chunk 256, 48 heads of 64) the three-operand einsum of the
    reference would build 12.9 GB a layer."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    xc = x.reshape(bs, nc, chunk, h, p)
    dtc = dt.reshape(bs, nc, chunk, h)
    bc = b.reshape(bs, nc, chunk, n)
    cc = c.reshape(bs, nc, chunk, n)

    cum = torch.cumsum(dtc * a, dim=2)                     # (B,nc,L,H) ≤ 0
    # --- intra-chunk (the "attention" dual) -------------------------------
    cb = (cc @ bc.transpose(-1, -2)).float()               # (B,nc,i,j)
    cumh = cum.transpose(2, 3)                             # (B,nc,H,L)
    seg = cumh[..., :, None] - cumh[..., None, :]          # (B,nc,H,i,j)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    # The reference (repro/models/ssm.py:118-121) takes exp of every (i, j)
    # and masks after: above the diagonal cum_i − cum_j is a positive sum of
    # −dt·a, which overflows to inf within tens of positions at its own init
    # (a = −e), and inf·0 is NaN.  Masking the exponent to −inf first gives
    # exactly 0 there (and a zero gradient), the same arithmetic wherever
    # the reference is finite.
    dec = torch.exp(torch.where(tri, seg, float("-inf")))
    xdt = (xc.float() * dtc[..., None]).permute(0, 1, 3, 2, 4)  # (B,nc,H,j,P)
    y_intra = (cb[:, :, None] * dec) @ xdt                 # (B,nc,H,i,P)
    # --- chunk states ------------------------------------------------------
    sdecay = torch.exp(cum[:, :, -1:, :] - cum)            # (B,nc,L,H)
    xs = (xc.float() * (sdecay * dtc)[..., None]).permute(0, 1, 3, 4, 2)
    s_chunk = xs @ bc.float()[:, :, None]                  # (B,nc,H,P,N)
    # --- inter-chunk recurrence -------------------------------------------
    total = torch.exp(cum[:, :, -1, :])                    # (B,nc,H)
    state = torch.zeros(bs, h, p, n, dtype=torch.float32, device=x.device)
    prevs = []
    for i in range(nc):
        prevs.append(state)
        state = total[:, i, :, None, None] * state + s_chunk[:, i]
    hprev = torch.stack(prevs, dim=1)                      # (B,nc,H,P,N)
    y_inter = (cc.float()[:, :, None] @ hprev.transpose(-1, -2)) \
        * cumh.exp()[..., None]                            # (B,nc,H,i,P)
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(bs, s, h, p)
    return y.to(x.dtype), state


def ssm_apply(p: dict, xin: torch.Tensor, cfg, *, mode: str = "train",
              ad=None, masks=None, use_kernel: bool = False) -> torch.Tensor:
    """One Mamba2 mixer over xin (B, S, d) in training mode → (B, S, d)."""
    if mode != "train":
        raise NotImplementedError(
            f"{cfg.name}: SSM {mode} (ssm_cache_meta, prefill's final state, "
            f"the decode recurrence) is not ported yet; see ROADMAP.md queue "
            f"1 item 13")
    ad = ad or {}
    masks = masks or {}
    scaling = cfg.adapter_alpha / max(cfg.adapter_rank, 1)
    d_inner, h, n, _ = _dims(cfg)
    bs, s, _ = xin.shape

    proj = L.dense_apply(p["in_proj"], xin, ad.get("in_proj"),
                         masks.get("in_proj"), scaling, use_kernel=use_kernel)
    z, xs, b, c, dt = _split(proj, cfg)
    a = -torch.exp(p["a_log"])                             # (H,) < 0
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus returns x itself
    # past its threshold of 20
    dt = torch.logaddexp(dt.float() + p["dt_bias"], torch.zeros(
        (), dtype=torch.float32, device=xin.device))

    xbc = _conv_causal(torch.cat([xs, b, c], dim=-1), p["conv_w"],
                       p["conv_b"])
    xs, b, c = torch.split(xbc, [d_inner, n, n], dim=-1)
    xh = xs.reshape(bs, s, h, -1)
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        chunk = s
    y, _ = ssd_chunked(xh, dt, a, b, c, chunk)
    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = _gated_norm(p["gate_norm"], y.reshape(bs, s, d_inner).to(xin.dtype),
                    z)
    return L.dense_apply(p["out_proj"], y, ad.get("out_proj"),
                         masks.get("out_proj"), scaling, use_kernel=use_kernel)
