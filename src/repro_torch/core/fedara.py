"""FedARA strategy (reference: ``repro/core/fedara.py``): binds truncated-SVD
adaptation, dynamic rank allocation and rank-based module pruning into
client/server hooks (paper Algorithm 1).

``Strategy`` is the reference's base (plain FedPEFT, no rank allocation);
``FedARA`` is the paper's strategy and ``FedSVD`` its ablation.  The
baselines live in :mod:`repro_torch.federated.baselines`, which also holds
the registry of all nine strategies (``all_strategies``).
``arbitrate_votes`` is the aggregate-only arbitration of secure
aggregation.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import adapters as AD
from repro_torch.core import arbitration as ARB
from repro_torch.core import comm as COMM
from repro_torch.core import importance as IMP
from repro_torch.core import masks as MK
from repro_torch.core import pruning as PR
from repro_torch.core import schedule as SCH


@dataclasses.dataclass
class Strategy:
    """Base strategy = plain FedPEFT (no rank allocation)."""
    name: str = "fedlora"
    peft: str = AD.LORA
    dtype_bytes: int = 4

    # ---- hooks -------------------------------------------------------------
    def init_rank(self, cfg) -> int:
        return cfg.adapter_rank

    def post_init(self, model, base, trainable):
        """Strategy-specific (re)initialization (FeDeRA, FFA-LoRA-dr).
        Returns (base, trainable); FeDeRA also rewrites the base."""
        return base, trainable

    def uses_masks(self) -> bool:
        return False

    def budget(self, rnd: int) -> int | None:
        return None

    def local_masks(self, rnd: int, adapters, grads, n_modules_ranks: int):
        return None

    def arbitrate(self, rnd: int, local_masks, prev_global):
        return prev_global

    def arbitrate_votes(self, rnd: int, vote_sums, n_reporting, prev_global):
        """Aggregate-only arbitration (secure aggregation hands the server
        vote *sums*, never per-client masks)."""
        return prev_global

    def optimizer_gate(self, trainable, masks):
        """0/1 tree over trainable leaves, or None."""
        return None

    def comm_down(self, trainable, masks) -> int:
        return COMM.count_params(trainable.get("adapters", {}), masks) \
            * self.dtype_bytes + self._head_bytes(trainable)

    def comm_up(self, trainable, masks) -> int:
        return self.comm_down(trainable, masks)

    def _head_bytes(self, trainable) -> int:
        head = trainable.get("head")
        if not head:
            return 0
        return sum(int(np.prod(tuple(v.shape))) for v in head.values()) \
            * self.dtype_bytes


@dataclasses.dataclass
class FedARA(Strategy):
    """The paper's strategy (Algorithm 1)."""
    name: str = "fedara"
    peft: str = AD.BEA
    importance: str = IMP.MAG
    threshold: float = 0.5                 # T_h
    target_rank_frac: float = 0.25         # T_r = r0/4 (paper §V)
    warmup_rounds: int = 5
    final_rounds_frac: float = 0.5         # decay ends at round T/2 (paper)
    total_rounds: int = 100
    module_pruning: bool = True

    _ema: Any = None

    def uses_masks(self) -> bool:
        return True

    def budget_params(self, n_rank_units: int):
        b0 = n_rank_units
        return dict(b0=b0,
                    b_target=int(b0 * self.target_rank_frac),
                    t_warmup=self.warmup_rounds,
                    t_final=int(self.total_rounds * self.final_rounds_frac),
                    total_rounds=self.total_rounds)

    def budget(self, rnd: int, n_rank_units: int | None = None) -> int | None:
        if n_rank_units is None:
            return None
        return SCH.rank_budget(rnd, **self.budget_params(n_rank_units))

    def local_masks(self, rnd: int, adapters, grads, n_rank_units: int):
        scores, self._ema = IMP.score_tree(adapters, grads, self.importance,
                                           ema_state=self._ema)
        return MK.generate_local_masks(scores, self.budget(rnd, n_rank_units))

    def arbitrate(self, rnd: int, local_masks, prev_global):
        if not local_masks:
            return prev_global
        return ARB.arbitrate(local_masks, self.threshold, prev_global)

    def arbitrate_votes(self, rnd: int, vote_sums, n_reporting, prev_global):
        if vote_sums is None or n_reporting <= 0:
            return prev_global
        return ARB.arbitrate_from_votes(vote_sums, n_reporting,
                                        self.threshold, prev_global)

    def optimizer_gate(self, trainable, masks):
        if not self.module_pruning or masks is None:
            return None
        out = {"adapters": PR.trainable_gate(trainable.get("adapters", {}),
                                             masks)}
        if "head" in trainable:
            out["head"] = {k: torch.ones((), device=v.device)
                           for k, v in trainable["head"].items()}
        return out

    def comm_down(self, trainable, masks) -> int:
        return COMM.bytes_down(trainable.get("adapters", {}), masks,
                               self.dtype_bytes) + self._head_bytes(trainable)

    def comm_up(self, trainable, masks) -> int:
        return self.comm_down(trainable, masks)


@dataclasses.dataclass
class FedSVD(Strategy):
    """Ablation: truncated-SVD adaptation without dynamic rank allocation."""
    name: str = "fedsvd"
    peft: str = AD.BEA

