"""Federated fine-tuning CLI (reference: ``repro/launch/fed_train.py``):
any of the nine strategies under any codec, secure aggregation and
client-level DP, through the seq, cohort or async runner.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.fed_train --rounds 20 \\
      --clients 20 --alpha 0.1
  PYTHONPATH=src python -m repro_torch.launch.fed_train --rounds 2 \\
      --clients 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.fed_train --strategy slora \\
      --rounds 3 --clients 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.fed_train --device cpu \\
      --codec signsgd --secagg mask --dp-clip 1.0 --dp-noise-multiplier 1.0
  PYTHONPATH=src python -m repro_torch.launch.fed_train --device cpu \\
      --strategy fedlora --runner cohort --fuse-rounds 2 --dropout 0.2
  PYTHONPATH=src python -m repro_torch.launch.fed_train --device cpu \\
      --strategy fedlora --runner async --buffer-k 2 --straggler 0.3
  PYTHONPATH=src python -m repro_torch.launch.fed_train --device cpu \\
      --runner cohort --codec signsgd --secagg mask --trace fed.jsonl \\
      --metrics-port 0

Runs the DistilBERT-family MINI classifier on CUDA unless ``--device cpu``
is given, and raises without a card.  ``--codec`` picks the delta-space
transport codec (int8 blockwise / top-k / 1-bit signsgd / low-rank
powersgd, with error feedback); ``--secagg mask`` and the DP flags compose
with the field-exact codecs (identity, signsgd) and print the reference's
protocol-bytes and ε lines.  ``--runner cohort`` trains each round's
clients in one forward per local step, ``--fuse-rounds K`` replays the
round as a CUDA graph in blocks of K where the config allows, and
``--runner async`` runs FedBuff-style buffered aggregation (``--buffer-k``,
with the reference's ``stale`` column); ``--dropout``, ``--straggler`` and
``--event-seed`` drive the simulated clients of both.  For SLoRA it prints
the reference's ``stage1:`` line.  ``--trace PATH`` writes the run's
``repro_torch.obs`` JSONL trace (``python -m repro_torch.obs summarize
PATH``), ``--trace-sample-clients`` head-samples its client spans and
``--metrics-port`` serves the live plane (``/metrics``, ``/healthz``,
``/snapshot``) while the run lasts.
"""

from __future__ import annotations

import argparse

from repro_torch import obs
from repro_torch.configs.distilbert import MINI
from repro_torch.data.synthetic import make_classification
from repro_torch.device import resolve_device
from repro_torch.federated.baselines import all_strategies
from repro_torch.federated.partition import (dirichlet_partition,
                                             pathological_partition)
from repro_torch.federated.server import (FedConfig, run_federated,
                                          validate_config)
from repro_torch.models import Model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", default="fedara",
                    choices=list(all_strategies()))
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--clients-per-round", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.1,
                    help="Dirichlet α; 0 → pathological split")
    ap.add_argument("--rank", type=int, default=12)
    ap.add_argument("--n-classes", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runner", default="seq",
                    choices=["seq", "cohort", "async"])
    ap.add_argument("--fuse-rounds", type=int, default=1, metavar="K",
                    help="cohort: K rounds per block, each a replay of one "
                         "captured CUDA graph of the round (1 ≡ eager loop; "
                         ">1 takes the fused fast path when codec/privacy/"
                         "ragged clients permit, else runs eagerly)")
    ap.add_argument("--opt-state-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"],
                    help="adam moment storage (bf16 halves per-client "
                         "optimizer state; int8 quarters the momentum)")
    ap.add_argument("--rebucket", action="store_true",
                    help="cohort: re-bucket each round's step axis to the "
                         "next pow-2 of the cohort's real max local steps")
    ap.add_argument("--codec", default="identity",
                    choices=["identity", "int8", "topk", "signsgd",
                             "powersgd"])
    ap.add_argument("--powersgd-rank", type=int, default=2,
                    help="q for --codec powersgd (q·(m+k) floats per wire)")
    ap.add_argument("--straggler", type=float, default=0.0,
                    help="P(client is a straggler); slowdown ×4")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="P(selected client never reports)")
    ap.add_argument("--buffer-k", type=int, default=0,
                    help="async: aggregate every K arrivals")
    ap.add_argument("--event-seed", type=int, default=0)
    ap.add_argument("--secagg", default="off", choices=["off", "mask"],
                    help="simulated secure aggregation (repro_torch.secagg)")
    ap.add_argument("--secagg-threshold", type=float, default=2.0 / 3.0,
                    help="Shamir threshold as a fraction of the cohort")
    ap.add_argument("--secagg-bits", type=int, default=32,
                    help="field modulus 2^bits for the masked sum")
    ap.add_argument("--dp-clip", type=float, default=0.0,
                    help="client-level DP: per-client delta L2 clip")
    ap.add_argument("--dp-noise-multiplier", type=float, default=0.0,
                    help="client-level DP: z (server noise = z·clip on sum)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a repro_torch.obs JSONL trace (spans + "
                         "metrics) here; inspect with `python -m "
                         "repro_torch.obs summarize`")
    ap.add_argument("--trace-sample-clients", type=float, default=None,
                    metavar="RATE",
                    help="head-sample per-client spans at this rate "
                         "(deterministic by (seed, round, client); clients "
                         "with health alerts always kept; cohort rollup "
                         "sketches preserve the dropped distributions)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve live telemetry on this port: /metrics "
                         "(Prometheus text), /healthz, /snapshot (tail with "
                         "`python -m repro_torch.obs top URL`); implies "
                         "tracing (in-memory only unless --trace)")
    args = ap.parse_args(argv)

    strat = all_strategies(rounds=args.rounds)[args.strategy]
    fc = FedConfig(rounds=args.rounds,
                   clients_per_round=args.clients_per_round, seed=args.seed,
                   runner=args.runner, codec=args.codec,
                   fuse_rounds=args.fuse_rounds,
                   opt_state_dtype=args.opt_state_dtype,
                   rebucket=args.rebucket,
                   powersgd_rank=args.powersgd_rank,
                   straggler=args.straggler, dropout=args.dropout,
                   buffer_k=args.buffer_k, event_seed=args.event_seed,
                   secagg=args.secagg,
                   secagg_threshold=args.secagg_threshold,
                   secagg_bits=args.secagg_bits, dp_clip=args.dp_clip,
                   dp_noise_multiplier=args.dp_noise_multiplier)
    validate_config(fc)
    device = resolve_device(args.device)

    tracing = args.trace is not None or args.metrics_port is not None
    live = None
    if tracing:
        obs.configure(args.trace, meta=obs.provenance(
            {"cmd": "fed_train", "strategy": args.strategy,
             "runner": args.runner, "codec": args.codec,
             "secagg": args.secagg, "run_device": device.type}),
            client_sample=args.trace_sample_clients, sample_seed=args.seed)
        if args.metrics_port is not None:
            live = obs.serve_live(port=args.metrics_port)
            print(f"live telemetry at {live.url}/metrics "
                  f"(/healthz, /snapshot)", flush=True)

    cfg = MINI.with_(n_classes=args.n_classes, adapter_rank=args.rank)
    train = make_classification(1500, args.n_classes, cfg.vocab_size, 32,
                                seed=1)
    test = make_classification(300, args.n_classes, cfg.vocab_size, 32,
                               seed=2)
    if args.alpha <= 0:
        parts = pathological_partition(train.labels, args.clients, 2,
                                       args.seed)
    else:
        parts = dirichlet_partition(train.labels, args.clients, args.alpha,
                                    args.seed)
    if hasattr(strat, "total_rounds"):
        strat.total_rounds = args.rounds
        strat.warmup_rounds = max(1, args.rounds // 10)
    model = Model(cfg.with_(adapter_rank=strat.init_rank(cfg)),
                  peft=strat.peft)

    def on_round(rnd, log):
        print(f"round {rnd:3d}  loss {log.loss:.4f}  "
              f"acc {log.acc if log.acc == log.acc else float('nan'):.4f}  "
              f"comm {(log.down_bytes + log.up_bytes) / 1e6:.2f} MB  "
              f"live_ranks {log.live_ranks}  dead_modules {log.dead_modules}"
              + (f"  sim {log.sim_time_s:.1f}s" if log.sim_time_s else "")
              + (f"  stale {log.staleness:.1f}" if log.staleness else ""),
              flush=True)

    try:
        h = run_federated(model, strat, parts, train, test, fc,
                          on_round=on_round, device=device)
    finally:
        if tracing:
            obs.close()
            if live is not None:
                live.stop()
    print(f"final acc {h['final_acc']:.4f}  total comm "
          f"{h['comm_gb'] * 1e3:.1f} MB  wall {h['wall_s']:.0f}s  "
          f"sim_time {h['sim_time_s']:.0f}s  device={device.type}")
    if h.get("secagg_rounds"):
        sr = h["secagg_rounds"]
        extra = sum(sum(p["down"] + p["up"] for p in r["phases"].values())
                    for r in sr)
        rec = sum(r["recovery_bytes"] for r in sr)
        print(f"secagg: {len(sr)} rounds  protocol bytes {extra / 1e6:.2f} MB"
              f"  recovery {rec / 1e3:.1f} kB")
    if h.get("dp"):
        print(f"DP: ε={h['dp']['epsilon']:.3f} @ δ={h['dp']['delta']:g}  "
              f"(z={h['dp']['noise_multiplier']}, clip={h['dp']['clip']})")
    if h.get("stage1"):
        s1 = h["stage1"]
        print(f"stage1: {s1['rounds']} rounds  up {s1['up_bytes'] / 1e6:.2f}"
              f" MB  clipped {s1['n_clipped']}")
    if args.trace:
        print(f"trace written to {args.trace}  "
              f"(python -m repro_torch.obs summarize {args.trace})")
    return h


if __name__ == "__main__":
    main()
