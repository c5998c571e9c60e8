"""Decoder-only language model for serving (reference: ``repro/models/lm.py``).

``Model`` builds the frozen base, the BEA/LoRA trainable tree, the rank-mask
tree and the KV-cache layout from an ``ArchConfig``, and serves through
``prefill`` / ``decode_step``.  Layers are a Python loop over per-layer
trees (``dec.layers[i]``) — no scan and no stacking.  ``decode_rows`` is the
batched multi-tenant decode: row ``i`` carries its own adapter (rank-bucket
stacks plus ``idx``) and its own cache position, which replaces the JAX
engine's ``vmap`` over batch-1 rows (``repro/serving/engine.py``).

``use_kernels=True`` sends every adapted linear and the prefill attention
through the kernel wrappers (CUDA kernels on the card, their plain versions
on the CPU); ``use_kernels=False`` runs the JAX package's plain form on any
device.
"""

from __future__ import annotations

import torch

from repro_torch.core import adapters as AD
from repro_torch.models import blocks as BK
from repro_torch.models import layers as L
from repro_torch.pytree import ParamMeta, materialize, tree_map


class Model:
    def __init__(self, cfg, peft: str = AD.BEA, use_kernels: bool = True):
        if cfg.is_encoder_decoder or cfg.modality != "text" or cfg.n_classes:
            raise NotImplementedError(
                f"{cfg.name}: only decoder-only text LMs are ported yet")
        self.cfg = cfg
        self.peft = peft
        self.use_kernels = use_kernels
        self.pattern = tuple(cfg.layer_pattern)

    # ---- metas ------------------------------------------------------------

    def base_meta(self) -> dict:
        cfg = self.cfg
        m: dict = {"embed": L.embed_meta(cfg),
                   "dec": {"layers": [BK.block_meta(cfg, k)
                                      for k in self.pattern]},
                   "final_norm": L.norm_meta(cfg)}
        if not cfg.tie_embeddings:
            m["head"] = ParamMeta((cfg.d_model, cfg.vocab_size), cfg.pdtype,
                                  init="normal")
        return m

    def adapter_meta(self) -> dict:
        if self.peft == "none":
            return {}
        return {"dec": {"layers": [
            BK.block_adapter_meta(self.cfg, k, self.peft)
            for k in self.pattern]}}

    def trainable_meta(self) -> dict:
        return {"adapters": self.adapter_meta()}

    def mask_meta(self) -> dict:
        """One boolean (r,) per adapter module."""
        def walk(tree):
            if isinstance(tree, dict) and "A" in tree and "B" in tree:
                return ParamMeta((tree["A"].shape[-2],), torch.bool,
                                 init="ones")
            if isinstance(tree, dict):
                return {k: walk(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [walk(v) for v in tree]
            raise TypeError(f"unexpected adapter meta {type(tree)!r}")

        return walk(self.adapter_meta())

    def cache_meta(self, batch: int, seq: int) -> dict:
        cfg = self.cfg
        return {"dec": {"layers": [BK.block_cache_meta(cfg, k, batch, seq)
                                   for k in self.pattern]},
                "pos": ParamMeta((batch,), torch.int64, init="zeros")}

    # ---- materialization ----------------------------------------------------

    def init(self, seed: int, device) -> tuple[dict, dict]:
        return (materialize(self.base_meta(), seed, device),
                materialize(self.trainable_meta(), seed, device))

    def init_masks(self, device) -> dict:
        return materialize(self.mask_meta(), 0, device)

    def init_cache(self, batch: int, seq: int, device) -> dict:
        return materialize(self.cache_meta(batch, seq), 0, device)

    # ---- forward ------------------------------------------------------------

    def _logits(self, base, x):
        cfg = self.cfg
        x = L.norm_apply(base["final_norm"], x, cfg)[:, -1]
        if cfg.tie_embeddings:
            logits = x @ base["embed"]["tok"].to(x.dtype).T
        else:
            logits = x @ base["head"].to(x.dtype)
        return L.softcap(logits.float(), cfg.final_softcap)

    def prefill(self, base, trainable, masks, tokens, cache=None):
        """tokens (B, S) from position 0 → (last-position logits (B, V) f32,
        new cache with k/v in ``[:S]`` and ``pos = S``)."""
        cfg = self.cfg
        ads = ((trainable or {}).get("adapters") or {}).get("dec") or {}
        msk = (masks or {}).get("dec") or {}
        x = L.embed_apply(base["embed"], tokens, cfg)
        new_layers = []
        for i, p in enumerate(base["dec"]["layers"]):
            x, nc = BK.block_apply(
                p, x, cfg, mode="prefill", ad=_layer(ads, i),
                masks=_layer(msk, i),
                cache=None if cache is None else cache["dec"]["layers"][i],
                use_kernel=self.use_kernels)
            new_layers.append(nc)
        new_cache = None
        if cache is not None:
            new_cache = {"dec": {"layers": new_layers},
                         "pos": torch.full_like(cache["pos"], tokens.shape[1])}
        return self._logits(base, x), new_cache

    def decode_rows(self, base, stacks, stack_masks, idx, tokens, cache,
                    rows):
        """One decode step for M rows of ``cache``, each with its own
        adapter and position.

        stacks / stack_masks: adapter and mask trees whose leaves carry a
        leading G axis (rank-bucket stacks); idx: (M,) int32 row → stack
        entry; tokens: (M,) int; rows: (M,) cache rows.  Writes each row's
        k/v at its position in place, advances ``cache["pos"][rows]`` and
        returns the logits (M, V) f32.
        """
        cfg = self.cfg
        ads = (stacks or {}).get("dec") or {}
        msk = (stack_masks or {}).get("dec") or {}
        pos = cache["pos"][rows]
        x = L.embed_apply(base["embed"], tokens[:, None], cfg)
        for i, p in enumerate(base["dec"]["layers"]):
            x, _ = BK.block_apply(
                p, x, cfg, mode="decode", ad=_layer(ads, i),
                masks=_layer(msk, i), cache=cache["dec"]["layers"][i],
                idx=idx, rows=rows, pos=pos, use_kernel=self.use_kernels)
        cache["pos"][rows] = pos + 1
        return self._logits(base, x)

    def decode_step(self, base, trainable, masks, token, cache):
        """token: (B, 1).  One step against the cache with one adapter tree
        for the whole batch; updates ``cache`` in place and returns it."""
        ads = (trainable or {}).get("adapters") or {}
        stacks = tree_map(lambda t: t[None], ads)
        stack_masks = tree_map(lambda t: t[None], masks or {})
        b = token.shape[0]
        dev = token.device
        logits = self.decode_rows(
            base, stacks, stack_masks, torch.zeros(b, dtype=torch.int32,
                                                   device=dev),
            token[:, 0], cache, torch.arange(b, device=dev))
        return logits, cache


def _layer(tree: dict, i: int):
    layers = tree.get("layers")
    return layers[i] if layers else None
