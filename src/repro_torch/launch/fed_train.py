"""Federated fine-tuning CLI (reference: ``repro/launch/fed_train.py``),
the sequential run of any of the nine strategies with the identity codec and
no privacy.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.fed_train --rounds 20 \\
      --clients 20 --alpha 0.1
  PYTHONPATH=src python -m repro_torch.launch.fed_train --rounds 2 \\
      --clients 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.fed_train --strategy slora \\
      --rounds 3 --clients 4 --device cpu

Runs the DistilBERT-family MINI classifier on CUDA unless ``--device cpu``
is given, and raises without a card.  The reference's other runners and
codecs are accepted by name and raise ``NotImplementedError`` with the
ROADMAP item that ports them.  For SLoRA it prints the reference's
``stage1:`` line.
"""

from __future__ import annotations

import argparse

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
    ap.add_argument("--codec", default="identity",
                    choices=["identity", "int8", "topk", "signsgd",
                             "powersgd"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    strat = all_strategies(rounds=args.rounds)[args.strategy]
    fc = FedConfig(rounds=args.rounds,
                   clients_per_round=args.clients_per_round, seed=args.seed,
                   runner=args.runner, codec=args.codec)
    validate_config(fc)
    device = resolve_device(args.device)

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
              + (f"  sim {log.sim_time_s:.1f}s" if log.sim_time_s else ""),
              flush=True)

    h = run_federated(model, strat, parts, train, test, fc,
                      on_round=on_round, device=device)
    print(f"final acc {h['final_acc']:.4f}  total comm "
          f"{h['comm_gb'] * 1e3:.1f} MB  wall {h['wall_s']:.0f}s  "
          f"sim_time {h['sim_time_s']:.0f}s  device={device.type}")
    if h.get("stage1"):
        s1 = h["stage1"]
        print(f"stage1: {s1['rounds']} rounds  up {s1['up_bytes'] / 1e6:.2f}"
              f" MB  clipped {s1['n_clipped']}")
    return h


if __name__ == "__main__":
    main()
