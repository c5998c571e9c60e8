"""Edge-device time and energy models (reference:
``repro/federated/devices.py``; paper §V Hardware, §VI-B/E).

The paper measures per-batch local training time on three devices and
combines it with a 1 MB/s server↔client link; these are those profiles and
the total-time and energy estimates for any strategy's per-round compute
and comm bytes.  Measured in the paper (batch size 4): RPi5 1.00 s per local
batch (DistilBERT) / 2.01 s (BERT); AGX Orin 6.67×/8.74× faster; Orin Nano
5.56×/6.70× faster.  They are the paper's device figures, used only to
price simulated rounds; none is a measurement of this port.
"""

from __future__ import annotations

import dataclasses

# seconds per local batch, batch size 4
PROFILES = {
    "rpi5": {"distilbert": 1.00, "bert": 2.01},
    "orin_nano": {"distilbert": 1.00 / 5.56, "bert": 2.01 / 6.70},
    "agx_orin": {"distilbert": 1.00 / 6.67, "bert": 2.01 / 8.74},
}
POWER_W = {"rpi5": 8.0, "orin_nano": 15.0, "agx_orin": 40.0}
BANDWIDTH = 1e6          # 1 MB/s (paper §V)

# deterministic client → device-class assignment
DEVICE_MIX = ("rpi5", "orin_nano", "agx_orin")


def device_of(cid: int) -> str:
    return DEVICE_MIX[int(cid) % len(DEVICE_MIX)]


def compute_s(cid: int, profile_name: str, n_batches: int,
              slow: float = 1.0) -> float:
    """Simulated local-training seconds for client ``cid``'s device class."""
    prof = PROFILES[device_of(cid)]
    per_batch = prof.get(profile_name, next(iter(prof.values())))
    return per_batch * n_batches * slow


@dataclasses.dataclass
class RoundCost:
    compute_s: float
    comm_s: float

    @property
    def total_s(self) -> float:
        return self.compute_s + self.comm_s


def round_cost(device: str, model_name: str, n_batches: int,
               down_bytes: int, up_bytes: int,
               compute_scale: float = 1.0) -> RoundCost:
    """``compute_scale`` models rank-based module pruning's reduction of the
    local step time."""
    t_comp = PROFILES[device][model_name] * n_batches * compute_scale
    t_comm = (down_bytes + up_bytes) / BANDWIDTH
    return RoundCost(t_comp, t_comm)


def total_time(device: str, model_name: str, per_round: list[RoundCost]
               ) -> float:
    return sum(r.total_s for r in per_round)


def energy_j(device: str, per_round: list[RoundCost],
             idle_frac: float = 0.35) -> float:
    """Compute at full power; communication at idle_frac·P (radio+idle)."""
    p = POWER_W[device]
    return sum(r.compute_s * p + r.comm_s * p * idle_frac for r in per_round)
