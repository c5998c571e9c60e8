"""Serving CLI (reference: ``repro/launch/serve.py``): the multi-tenant
serving engine for decoder-only text models, and the static-batch loop
(``legacy_static_batch``) for encoder-decoder and vision models, which the
engine does not take.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      --batch 8 --tenants 2 --prompt-len 128 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --trace serve.jsonl --metrics-port 0
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch internvl2_1b --batch 2 --prompt-len 8 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch bart --full \\
      --batch 4 --prompt-len 128 --gen 16

Runs on CUDA unless ``--device cpu`` is given; ``--full`` serves the
published config of ``--arch`` (Qwen2-0.5B by default), the default its
reduced smoke variant.  ``--trace PATH`` writes the engine's
``repro_torch.obs`` JSONL trace (its steps, the scheduler's counters, the
token counters and latency sketches) and ``--metrics-port`` serves the
live plane while it runs (the engine path only).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.pytree import materialize, tree_map


def make_tenants(model, cfg, n_tenants: int, ranks=None, seed: int = 0,
                 device="cpu"):
    """Simulated post-federated tenants: one BEA adapter tree per tenant at
    its own rank (round-robin over ``ranks``), E bumped off its zero init so
    the adapters actually steer generation, plus a pruned top rank."""
    ranks = list(ranks or [max(cfg.adapter_rank // 2, 1), cfg.adapter_rank])
    rng = np.random.default_rng(seed)
    tenants = {}
    for i in range(n_tenants):
        r = ranks[i % len(ranks)]
        m_t = Model(cfg.with_(adapter_rank=r), peft="bea")
        tr = materialize(m_t.trainable_meta(), seed, device)

        def bump(tree):
            if isinstance(tree, dict):
                return {k: torch.as_tensor(rng.normal(size=tuple(v.shape))
                                           * 0.05, dtype=v.dtype,
                                           device=v.device)
                        if k == "E" else bump(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [bump(v) for v in tree]
            return tree

        masks = m_t.init_masks(device)
        if r > 1:                       # CommPru'd top rank
            def prune(m):
                m = m.clone()
                m[..., -1] = False
                return m
            masks = tree_map(prune, masks)
        tenants[f"client{i}"] = dict(trainable=bump(tr), masks=masks, rank=r)
    return tenants


def build_engine(cfg, *, n_slots: int, max_seq: int, n_tenants: int = 1,
                 ranks=None, seed: int = 0, device=None):
    """Model + frozen base + engine with ``n_tenants`` registered adapters,
    materialized directly on ``device`` (CUDA unless ``"cpu"`` is asked)."""
    from repro_torch.serving import ServingEngine

    dev = resolve_device(device)
    model = Model(cfg, peft="bea")
    base = materialize(model.base_meta(), seed, dev)
    engine = ServingEngine(model, base, n_slots=n_slots, max_seq=max_seq,
                           device=dev)
    for tid, spec in make_tenants(model, cfg, n_tenants, ranks, seed,
                                  dev).items():
        engine.register_adapter(tid, spec["trainable"], spec["masks"],
                                rank=spec["rank"], alpha=cfg.adapter_alpha)
    return engine


def serve_requests(engine, prompts, adapter_ids, gen: int):
    """Submit (prompt, adapter) pairs, run to completion, return requests.

    Raises if any request was rejected at submit time — a silent drop would
    masquerade as an empty generation.
    """
    reqs = [engine.submit(aid, p, gen) for p, aid in zip(prompts, adapter_ids)]
    bad = [r for r in reqs if r.state == "rejected"]
    if bad:
        raise ValueError(
            f"{len(bad)}/{len(reqs)} requests rejected, first: {bad[0].error}")
    engine.run()
    return reqs


def static_batch_inputs(cfg, batch: int, prompt_len: int, device,
                        seed: int = 0) -> dict:
    """The static-batch loop's requests, from one numpy generator as the
    reference draws them: ``tokens`` (B, prompt_len), an encoder-decoder's
    ``enc_tokens`` (B, 2·prompt_len) or a vision model's ``prefix_embeds``
    (B, P, d), normal × 0.1 in the compute dtype."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)), device=device)}
    if cfg.is_encoder_decoder:          # audio frames wait for seamless
        out["enc_tokens"] = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (batch, 2 * prompt_len)),
            device=device)
    if cfg.modality == "vision":
        out["prefix_embeds"] = torch.as_tensor(
            rng.normal(size=(batch, cfg.n_prefix_embeds, cfg.d_model)) * 0.1,
            dtype=cfg.cdtype, device=device)
    return out


def legacy_static_batch(cfg, args, params=None, use_kernels: bool = True,
                        force=None) -> dict:
    """The static-batch loop for encoder-decoder and vision models
    (reference ``:83-131``): the whole batch prefilled at once, then
    ``args.gen − 1`` greedy decode steps of the whole batch, one adapter
    tree for all rows.

    ``params``: (base, trainable, masks) on ``args.device`` in place of the
    seed-0 init; ``use_kernels=False`` runs the kernels' plain versions;
    ``force`` (B, gen): the tokens to feed in place of the greedy ones (a
    teacher-forced replay of another run).  → {"tokens" (B, gen), "logits"
    [(B, V) f32 per step, prefill's first], "prefill_s", "decode_s" (host
    wall, device-synchronized)}."""
    dev = resolve_device(args.device)
    model = Model(cfg, peft="bea", use_kernels=use_kernels)
    if params is None:
        base, trainable = model.init(0, dev)
        params = (base, trainable, model.init_masks(dev))
    base, trainable, masks = params
    batch = static_batch_inputs(cfg, args.batch, args.prompt_len, dev)
    n_prefix = cfg.n_prefix_embeds if cfg.modality == "vision" else 0
    # the reference sizes its cache prompt + gen and so has no room for the
    # prefix rows its prefill writes (ROADMAP.md queue 4 quirk 12): the
    # port's cache holds them
    total = n_prefix + args.prompt_len + args.gen
    src_len = 2 * args.prompt_len if cfg.is_encoder_decoder else 0
    cache = model.init_cache(args.batch, total, dev, src_len=src_len)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def pick(logits, i):
        tok = logits.argmax(-1) if force is None else force[:, i]
        return tok[:, None].long()

    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(base, trainable, masks, batch, cache)
        tok = pick(logits, 0)
        sync()
        t_prefill = time.perf_counter() - t0
        out, steps = [tok], [logits]
        for i in range(1, args.gen):
            logits, cache = model.decode_step(base, trainable, masks, tok,
                                              cache)
            tok = pick(logits, i)
            out.append(tok)
            steps.append(logits)
        sync()
        t_decode = time.perf_counter() - t0 - t_prefill
    gen = torch.cat(out, dim=1)
    print(f"arch={cfg.name} [legacy static batch] device={dev} "
          f"batch={args.batch} prompt={args.prompt_len} gen={args.gen}"
          + (f" prefix={n_prefix}" if n_prefix else "")
          + (f" src={src_len}" if src_len else ""))
    print(f"prefill {t_prefill * 1e3:.1f} ms, "
          f"decode {t_decode / max(args.gen - 1, 1) * 1e3:.1f} ms/token")
    print("generated token ids (first request):", gen[0].tolist())
    return {"tokens": gen, "logits": steps, "prefill_s": t_prefill,
            "decode_s": t_decode}


def main(argv=None):
    ap = argparse.ArgumentParser()
    # the ported decoders through the engine; the encoder-decoder and the
    # vision model through the static-batch loop (DistilBERT and BERT are
    # encoders: they train, not serve)
    ap.add_argument("--arch", default="qwen2_0p5b",
                    choices=["qwen2_0p5b", "internvl2_1b", "bart"])
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests to serve")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--tenants", type=int, default=2,
                    help="distinct adapters (round-robin across requests)")
    ap.add_argument("--slots", type=int, default=0,
                    help="engine cache slots (0 → min(batch, 8))")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a repro_torch.obs JSONL trace (engine steps, "
                         "scheduler metrics, token counters) here")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve live telemetry on this port: /metrics "
                         "(Prometheus text), /healthz, /snapshot; implies "
                         "tracing (in-memory only unless --trace)")
    args = ap.parse_args(argv)
    for name in ("batch", "tenants", "gen", "prompt_len"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1")

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.is_encoder_decoder or cfg.modality == "vision":
        legacy_static_batch(cfg, args)
        return
    tracing = args.trace is not None or args.metrics_port is not None
    live = None
    if tracing:
        obs.configure(args.trace, meta=obs.provenance(
            {"cmd": "serve", "arch": args.arch, "tenants": args.tenants,
             "slots": args.slots, "gen": args.gen}))
        if args.metrics_port is not None:
            live = obs.serve_live(port=args.metrics_port)
            print(f"live telemetry at {live.url}/metrics "
                  f"(/healthz, /snapshot)", flush=True)
    try:
        _serve(cfg, args)
    finally:
        if tracing:
            obs.close()
            if live is not None:
                live.stop()
    if args.trace:
        print(f"trace written to {args.trace}")


def _serve(cfg, args) -> None:
    n_slots = args.slots or min(args.batch, 8)
    max_seq = args.prompt_len + args.gen
    engine = build_engine(cfg, n_slots=n_slots, max_seq=max_seq,
                          n_tenants=args.tenants, device=args.device)
    rng = np.random.default_rng(0)
    tenant_ids = engine.registry.ids()
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len)
               for _ in range(args.batch)]
    adapter_ids = [tenant_ids[i % len(tenant_ids)]
                   for i in range(args.batch)]

    t0 = time.perf_counter()
    reqs = serve_requests(engine, prompts, adapter_ids, args.gen)
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in reqs)
    print(f"arch={cfg.name} device={engine.device} requests={args.batch} "
          f"tenants={args.tenants} slots={n_slots} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"{n_tok} tokens in {wall:.2f}s ({n_tok / wall:.1f} tok/s), "
          f"{engine.steps} engine steps, {engine.decode_calls} decode calls")
    print("generated token ids (first request):", reqs[0].out)
    obs.get_metrics().gauge("serve.tokens_per_s").set(n_tok / wall)


if __name__ == "__main__":
    main()
