"""Centralized LM fine-tuning entry point, PEFT on a frozen base (reference:
``repro/launch/train.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2_0p5b --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch bart
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0p5b \\
      --full --steps 20 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3_1b \\
      --full --steps 20 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch granite_moe_1b_a400m --smoke --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2_1b \\
      --full --steps 20 --batch 8 --seq 512

Runs on CUDA (``--device``, default ``cuda``; it raises without a card)
through the kernels; ``--device cpu`` runs their plain versions.  The
reduced config by default (``--smoke``), the published one with
``--full``.  The data is the reference's: ``make_lm_stream(steps·batch,
vocab, seq, seed=0)``, the encoder-decoder's encoder reading the same
tokens, a vision model's ``n_prefix_embeds`` patch embeddings zeros.  An
MoE model's progress lines also print its router aux loss (the step's
``metric``; the loss printed is the LM loss without it).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import optim as OPT
from repro_torch.configs import ARCH_IDS, PAPER_IDS, get_config
from repro_torch.data.synthetic import make_lm_stream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models import Model


def schedule(name: str, lr: float, steps: int):
    return {"linear": lambda: OPT.linear_decay(lr, steps),
            "cosine": lambda: OPT.cosine(lr, steps, warmup=steps // 10),
            "wsd": lambda: OPT.wsd(lr, steps),
            "constant": lambda: OPT.constant(lr)}[name]()


def run(cfg, *, peft: str = "bea", steps: int = 50, batch: int = 4,
        seq: int = 64, lr: float = 2e-3, sched: str = "linear",
        device="cuda", use_kernels: bool = True) -> dict:
    """The training loop of :func:`main` → {"losses": per-step losses,
    "aux": per-step router aux losses (0 without MoE layers), "wall_s":
    the loop's seconds, "base", "trainable", "masks": the trained state,
    "tokens", "targets": the data on the device}.
    ``use_kernels=False`` runs the same loop through the kernels' plain
    versions."""
    dev = resolve_device(device)
    model = Model(cfg, peft=peft, use_kernels=use_kernels)
    base, trainable = model.init(0, dev)
    masks = model.init_masks(dev)
    opt = OPT.adam(schedule(sched, lr, steps))
    opt_state = opt.init(trainable)
    step = ST.make_train_step(model, opt, task="lm")

    data = make_lm_stream(steps * batch, cfg.vocab_size, seq, seed=0)
    tokens = torch.as_tensor(data["tokens"], device=dev).long()
    targets = torch.as_tensor(data["targets"], device=dev).long()
    losses, aux = [], []
    t0 = time.time()
    for i in range(steps):
        sl = slice(i * batch, (i + 1) * batch)
        b = {"tokens": tokens[sl], "targets": targets[sl]}
        if cfg.modality == "vision":        # the reference's zero patches
            b["prefix_embeds"] = torch.zeros(
                batch, cfg.n_prefix_embeds, cfg.d_model, dtype=cfg.cdtype,
                device=dev)
        if cfg.is_encoder_decoder:
            b["enc_tokens"] = b["tokens"]
        trainable, opt_state, metrics = step(base, trainable, opt_state,
                                             masks, b)
        losses.append(metrics["loss"])
        aux.append(metrics["metric"])
        if i % max(steps // 10, 1) == 0 or i == steps - 1:
            # deliberate sync point: progress log every 10% of steps
            router = (f"aux {float(metrics['metric']):.4f}  "  # lint: disable=RL2
                      if cfg.n_experts else "")
            print(f"step {i:4d}  loss {float(metrics['loss']):.4f}  "  # lint: disable=RL2
                  f"{router}({time.time() - t0:.1f}s)", flush=True)
    wall = time.time() - t0
    print(f"done: {steps} steps in {wall:.1f}s")
    return {"losses": torch.stack(losses).tolist(),
            "aux": torch.stack(aux).tolist(), "wall_s": wall,
            "base": base, "trainable": trainable, "masks": masks,
            "tokens": tokens, "targets": targets}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0p5b",
                    choices=ARCH_IDS + PAPER_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--peft", default="bea",
                    choices=["bea", "lora", "ffa", "none"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--schedule", default="linear",
                    choices=["linear", "cosine", "wsd", "constant"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    return run(cfg, peft=args.peft, steps=args.steps, batch=args.batch,
               seq=args.seq, lr=args.lr, sched=args.schedule,
               device=args.device)


if __name__ == "__main__":
    main()
