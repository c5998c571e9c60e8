"""Language model, encoder-decoder and encoder classifier (reference:
``repro/models/lm.py``).

``Model`` builds the frozen base, the BEA/LoRA trainable tree (plus the
classifier head where the config has classes), the rank-mask tree and the
KV-cache layout from an ``ArchConfig``.  It trains through ``forward`` /
``cls_loss`` / ``lm_loss`` and serves through ``prefill`` / ``decode_step``
(not yet configs with a sliding window, an attention soft-cap, MoE
blocks, Mamba2 SSM blocks or a shared block).  A vision config (InternVL2)
takes ``batch["prefix_embeds"]`` (B, P, d), precomputed patch embeddings
that run through the decoder in front of the tokens (RoPE positions
0…P+S−1) and are sliced off after the final norm, so the logits cover the
tokens only.  MoE blocks add their
router's load-balance loss to ``lm_loss`` (``router_aux_coef · aux``, aux
summed over the layers).  An encoder-decoder config (BART) gets an
``enc`` stack (``enc`` blocks, then ``enc_norm``) whose output every ``dec``
block cross-attends to.  Layers are a Python loop over per-layer trees
(``dec.layers[i]``, ``enc.layers[i]``) — no scan and no stacking.  A
``shared_attn`` position (Zamba2) has an empty ``dec.layers[i]``: its
params, adapters and masks are the one ``dec.shared`` tree, used at every
such position, so each shared tensor is one leaf (Adam steps it once a
step, byte counts and masks see it once) and its gradient is the sum over
the occurrences.
``decode_rows`` is the batched multi-tenant decode: row ``i`` carries its
own adapter (rank-bucket stacks plus ``idx``) and its own cache position,
which replaces the JAX engine's ``vmap`` over batch-1 rows
(``repro/serving/engine.py``).

``use_kernels=True`` sends every adapted linear and the train/prefill
attention through the kernel wrappers (differentiable in training) (CUDA kernels on the card, their plain versions
on the CPU); ``use_kernels=False`` runs the JAX package's plain form on any
device.
"""

from __future__ import annotations

import torch

from repro_torch.core import adapters as AD
from repro_torch.models import blocks as BK
from repro_torch.models import layers as L
from repro_torch.models.plan import SHARED
from repro_torch.pytree import ParamMeta, materialize, tree_map


class Model:
    def __init__(self, cfg, peft: str = AD.BEA, use_kernels: bool = True):
        if cfg.modality not in ("text", "vision"):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.modality} modality (precomputed "
                f"frames into an encoder-decoder) is not ported yet; see "
                f"ROADMAP.md queue 1 item 12")
        self.cfg = cfg
        self.peft = peft
        self.use_kernels = use_kernels
        self.pattern = tuple(cfg.layer_pattern)
        self.enc_pattern = ()
        if cfg.is_encoder_decoder:      # decoder blocks get cross-attention
            self.pattern = tuple("dec" if k == "attn" else k
                                 for k in self.pattern)
            self.enc_pattern = ("enc",) * cfg.n_encoder_layers

    # ---- metas ------------------------------------------------------------

    def base_meta(self) -> dict:
        cfg = self.cfg
        m: dict = {"embed": L.embed_meta(cfg)}
        if cfg.is_encoder_decoder:
            m["enc"] = _stack_meta(self.enc_pattern,
                                   lambda k: BK.block_meta(cfg, k))
            m["enc_norm"] = L.norm_meta(cfg)
        m["dec"] = _stack_meta(self.pattern, lambda k: BK.block_meta(cfg, k))
        m["final_norm"] = L.norm_meta(cfg)
        if not cfg.tie_embeddings:
            m["head"] = ParamMeta((cfg.d_model, cfg.vocab_size), cfg.pdtype,
                                  init="normal")
        return m

    def adapter_meta(self) -> dict:
        if self.peft == "none":
            return {}
        out = {}
        for stack, pattern in (("enc", self.enc_pattern),
                               ("dec", self.pattern)):
            if pattern:
                out[stack] = _stack_meta(pattern, lambda k: (
                    BK.block_adapter_meta(self.cfg, k, self.peft)))
        return out

    def trainable_meta(self) -> dict:
        out = {"adapters": self.adapter_meta()}
        if self.cfg.n_classes:
            out["head"] = {
                "w": ParamMeta((self.cfg.d_model, self.cfg.n_classes),
                               torch.float32, init="normal"),
                "b": ParamMeta((self.cfg.n_classes,), torch.float32,
                               init="zeros")}
        return out

    def mask_meta(self) -> dict:
        """One boolean (r,) per adapter module, a per-expert module's
        shared by its experts (A's expert axis is not the mask's).
        Bottleneck adapters have no ranks to mask (the FedAdapter
        strategies use no masks)."""
        if self.peft in BK.BOTTLENECK_KINDS:
            raise ValueError(f"peft {self.peft!r} has no rank masks")

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

    def cache_meta(self, batch: int, seq: int, src_len: int = 0) -> dict:
        """Each decoder block's cache over ``seq`` positions (a vision
        model's prefix rows included), a ``dec`` block's cross-attention
        cache over the encoder's ``src_len``, and each row's position."""
        cfg = self.cfg
        self._require_servable("serving")
        return {"dec": {"layers": [BK.block_cache_meta(cfg, k, batch, seq,
                                                       src_len)
                                   for k in self.pattern]},
                "pos": ParamMeta((batch,), torch.int64, init="zeros")}

    # ---- materialization ----------------------------------------------------

    def init(self, seed: int, device) -> tuple[dict, dict]:
        return (materialize(self.base_meta(), seed, device),
                materialize(self.trainable_meta(), seed, device))

    def init_masks(self, device) -> dict:
        return materialize(self.mask_meta(), 0, device)

    def init_cache(self, batch: int, seq: int, device,
                   src_len: int = 0) -> dict:
        return materialize(self.cache_meta(batch, seq, src_len), 0, device)

    # ---- training forward -----------------------------------------------------

    def _stack(self, stack, pattern, x, ads, msk, clients, enc_out=None,
               route=None, record=None, mode="train"):
        """``stack``: ``{"layers": [...], "shared": ...}`` (``dec``, ``enc``)
        → (x, aux summed over the layers, None if no layer has one)."""
        aux = None
        for i, kind in enumerate(pattern):
            if kind == SHARED:
                p, ad, mk = stack["shared"], ads.get("shared"), msk.get(
                    "shared")
            else:
                p, ad, mk = stack["layers"][i], _layer(ads, i), _layer(msk, i)
            r = next(route) if route is not None and BK.is_moe(kind) else None
            x, a, _ = BK.block_apply(p, x, self.cfg, mode=mode, kind=kind,
                                     ad=ad, masks=mk,
                                     use_kernel=self.use_kernels,
                                     clients=clients, enc_out=enc_out,
                                     route=r, record=record)
            if BK.is_moe(kind):
                aux = a if aux is None else aux + a
        return x, aux

    def forward(self, base, trainable, masks, batch, clients: bool = False):
        """Train-mode forward over ``batch["tokens"]`` (B, S) from position 0
        (an encoder-decoder's encoder over ``batch["enc_tokens"]`` (B, Se)
        first; a vision model's ``batch["prefix_embeds"]`` (B, P, d) in
        front of the tokens, dropped before the head).  With a classifier
        head (the config has classes and the
        trainable tree a ``head``) → logits (B, n_classes): the final-normed
        sequence mean-pooled in f32, then ``pooled @ w + b``.  Otherwise →
        LM logits (B, S, V) in f32: the final-normed sequence times
        ``embed.tok``ᵀ (tied) or ``head`` (untied), soft-capped by
        ``final_softcap``.

        ``clients=True`` is the cohort's form (the reference's ``vmap`` over
        clients with the base shared): tokens (C, B, S), every trainable
        leaf with a leading C, the base and the masks shared → logits with
        a leading C."""
        return self._forward(base, trainable, masks, batch, clients)[0]

    def _forward(self, base, trainable, masks, batch, clients: bool = False,
                 *, route=None, record=None):
        """:meth:`forward` → (logits, aux): ``aux`` the MoE layers' router
        losses summed (None without MoE layers).  ``route``: one (B·S, k)
        expert choice per MoE layer, in layer order, in place of each
        router's top-k; ``record``: a list that gets each MoE layer's choice
        and dropped count (``models/moe.py:moe_apply``).  Both are for
        comparing two runs routed alike; the entry points pass neither."""
        cfg = self.cfg
        ads = (trainable or {}).get("adapters") or {}
        msk = masks or {}
        if clients and "prefix_embeds" in batch:
            raise NotImplementedError(
                f"{cfg.name}: the cohort's client-batched forward with a "
                f"vision prefix is not ported: no reference runner trains a "
                f"vision model federated (see ROADMAP.md queue 1 item 12)")
        enc_out = self._encode(base, ads, msk, batch, clients, "train")
        x, n_prefix = self._embed(base, batch)
        x, aux = self._stack(base["dec"], self.pattern, x,
                             ads.get("dec") or {}, msk.get("dec") or {},
                             clients, enc_out,
                             None if route is None else iter(route), record)
        x = L.norm_apply(base["final_norm"], x, cfg)[..., n_prefix:, :]
        head = (trainable or {}).get("head")
        if head and cfg.n_classes:
            # mean pooling: with a random frozen base it carries the signal
            pooled = x.mean(dim=-2).float()
            if clients:
                logits = pooled @ head["w"] + head["b"][:, None]
            else:
                logits = pooled @ head["w"] + head["b"]
        else:
            logits = self._vocab_logits(base, x)
        return logits, aux

    def _encode(self, base, ads, msk, batch, clients=False, mode="train"):
        """An encoder-decoder's encoder over ``batch["enc_tokens"]``, then
        its final norm → enc_out (None without an encoder)."""
        cfg = self.cfg
        if not cfg.is_encoder_decoder:
            return None
        ex = L.embed_apply(base["embed"], batch["enc_tokens"], cfg)
        ex, _ = self._stack(base["enc"], self.enc_pattern, ex,
                            ads.get("enc") or {}, msk.get("enc") or {},
                            clients, mode=mode)
        return L.norm_apply(base["enc_norm"], ex, cfg)

    def _embed(self, base, batch):
        """The tokens' embeddings, a vision model's prefix embeddings (cast
        to the compute dtype) in front of them → (x, prefix rows)."""
        x = L.embed_apply(base["embed"], batch["tokens"], self.cfg)
        pe = batch.get("prefix_embeds")
        if pe is None:
            return x, 0
        return torch.cat([pe.to(self.cfg.cdtype), x], dim=-2), pe.shape[-2]

    def _vocab_logits(self, base, x):
        """x (..., d) → soft-capped f32 logits (..., V): a plain product, as
        the JAX package leaves it outside any kernel."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = x @ base["embed"]["tok"].to(x.dtype).T
        else:
            logits = x @ base["head"].to(x.dtype)
        return L.softcap(logits.float(), cfg.final_softcap)

    def lm_loss(self, base, trainable, masks, batch, clients: bool = False,
                *, route=None, record=None):
        """Mean next-token NLL over the positions whose ``batch["targets"]``
        is ≥ 0 (log-softmax in f32) → (total, (loss, aux)), the reference's
        layout: ``total = loss + router_aux_coef·aux``, ``aux`` the MoE
        layers' load-balance losses summed (0 without MoE layers).
        ``route``, ``record``: as :meth:`_forward`'s.

        ``clients=True`` (targets (C, B, S)): each client's loss and aux
        (C,), and as the total their sum, so that each client's gradient is
        its own loss's."""
        logits, aux = self._forward(base, trainable, masks, batch, clients,
                                    route=route, record=record)
        targets = batch["targets"]
        valid = targets >= 0
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, torch.where(valid, targets, 0)[..., None])[..., 0]
        dims = tuple(range(1 if clients else 0, nll.ndim))
        vf = valid.float()
        loss = (nll * vf).sum(dims) / vf.sum(dims).clamp(min=1.0)
        if aux is None:
            aux = torch.zeros_like(loss)
        total = loss + self.cfg.router_aux_coef * aux
        return (total.sum() if clients else total), (loss, aux)

    def cls_loss(self, base, trainable, masks, batch, clients: bool = False):
        """Mean cross-entropy over ``batch["labels"]`` → (total, (loss,
        acc)), the reference's layout: ``total = loss`` plus
        ``router_aux_coef·aux`` where the model has MoE layers.

        ``clients=True`` (labels (C, B)): each client's mean loss and
        accuracy (C,), and as the total their sum, so that each client's
        gradient is its own loss's."""
        logits, aux = self._forward(base, trainable, masks, batch, clients)
        labels = batch["labels"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        if clients:
            loss = -logp.gather(-1, labels[..., None])[..., 0].mean(-1)
            acc = (logits.argmax(-1) == labels).float().mean(-1)
            return loss.sum(), (loss, acc)
        loss = -logp.gather(-1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        total = loss if aux is None else loss + self.cfg.router_aux_coef * aux
        return total, (loss, acc)

    # ---- serving forward ------------------------------------------------------

    def _require_servable(self, what: str) -> None:
        """Serving takes decoder-only, encoder-decoder and vision configs
        without a sliding window, an attention soft-cap, MoE, SSM or shared
        blocks: the ring-buffer cache of windowed layers, MoE prefill and
        decode, the SSM state cache and a shared block's cache per
        occurrence are not ported yet."""
        cfg = self.cfg
        if cfg.sliding_window or cfg.attn_softcap:
            raise NotImplementedError(
                f"{cfg.name}: {what} with a sliding window or attention "
                f"soft-cap (the ring-buffer cache) is not ported yet; see "
                f"ROADMAP.md queue 1 item 13")
        if any(BK.is_moe(k) for k in self.pattern):
            raise NotImplementedError(
                f"{cfg.name}: {what} of MoE blocks is not ported yet; see "
                f"ROADMAP.md queue 1 item 13")
        if "mamba" in self.pattern:
            raise NotImplementedError(
                f"{cfg.name}: {what} of SSM blocks (ssm_cache_meta, "
                f"prefill's final state, the decode recurrence) is not "
                f"ported yet; see ROADMAP.md queue 1 item 13")
        if SHARED in self.pattern:
            raise NotImplementedError(
                f"{cfg.name}: {what} of a shared attention block (a KV cache "
                f"per occurrence) is not ported yet; see ROADMAP.md queue 1 "
                f"item 13")

    def _logits(self, base, x):
        x = L.norm_apply(base["final_norm"], x, self.cfg)[:, -1]
        return self._vocab_logits(base, x)

    def prefill(self, base, trainable, masks, batch, cache=None):
        """``batch``: tokens (B, S), or a dict of ``"tokens"`` (B, S) and a
        vision model's ``"prefix_embeds"`` (B, P, d) or an encoder-decoder's
        ``"enc_tokens"`` (B, Se).  The encoder runs once; every position from
        0 (the P prefix rows first) → (last-position logits (B, V) f32, new
        cache with self-attention k/v in ``[:P+S]``, the encoder's k/v in
        each cross-attention cache, and ``pos = P + S``)."""
        cfg = self.cfg
        self._require_servable("prefill")
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        ads = (trainable or {}).get("adapters") or {}
        msk = masks or {}
        enc_out = self._encode(base, ads, msk, batch, mode="prefill")
        ads, msk = ads.get("dec") or {}, msk.get("dec") or {}
        x, _ = self._embed(base, batch)
        new_layers = []
        for i, (kind, p) in enumerate(zip(self.pattern,
                                          base["dec"]["layers"])):
            x, _, nc = BK.block_apply(
                p, x, cfg, mode="prefill", kind=kind, ad=_layer(ads, i),
                masks=_layer(msk, i),
                cache=None if cache is None else cache["dec"]["layers"][i],
                use_kernel=self.use_kernels, enc_out=enc_out)
            new_layers.append(nc)
        new_cache = None
        if cache is not None:
            # the prefix rows hold cache positions 0…P−1: decode goes on
            # from P + S
            new_cache = {"dec": {"layers": new_layers},
                         "pos": torch.full_like(cache["pos"], x.shape[1])}
        return self._logits(base, x), new_cache

    def decode_rows(self, base, stacks, stack_masks, idx, tokens, cache,
                    rows):
        """One decode step for M rows of ``cache``, each with its own
        adapter and position.

        stacks / stack_masks: adapter and mask trees whose leaves carry a
        leading G axis (rank-bucket stacks); idx: (M,) int32 row → stack
        entry; tokens: (M,) int; rows: (M,) cache rows.  Writes each row's
        k/v at its position in place, advances ``cache["pos"][rows]`` and
        returns the logits (M, V) f32.  A ``dec`` block cross-attends to
        the encoder's k/v that prefill left in its cache.  The new token is
        embedded at learned position 0, as the reference's decode embeds it
        (``repro/models/lm.py:326``: no position offset; ROADMAP.md queue 4
        quirk 13).
        """
        cfg = self.cfg
        self._require_servable("decode")
        ads = (stacks or {}).get("dec") or {}
        msk = (stack_masks or {}).get("dec") or {}
        pos = cache["pos"][rows]
        x = L.embed_apply(base["embed"], tokens[:, None], cfg)
        for i, (kind, p) in enumerate(zip(self.pattern,
                                          base["dec"]["layers"])):
            x, _, _ = BK.block_apply(
                p, x, cfg, mode="decode", kind=kind, ad=_layer(ads, i),
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


def _stack_meta(pattern, build) -> dict:
    """``{"layers": [build(kind) for each layer]}``, an empty entry at each
    ``shared_attn`` position and, where there is one, the shared block's
    tree once under ``"shared"`` (the reference's ``_plan_meta`` builds
    it from ``"attn"``, and leaves it out where it would be empty)."""
    out = {"layers": [{} if k == SHARED else build(k) for k in pattern]}
    if SHARED in pattern:
        shared = build(SHARED)
        if shared:
            out["shared"] = shared
    return out


def _layer(tree: dict, i: int):
    layers = tree.get("layers")
    return layers[i] if layers else None
