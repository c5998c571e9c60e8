"""Edge-device compute profiles (reference: ``repro/federated/devices.py``,
the part the simulated clock reads; paper §V Hardware, §VI-B).

Measured in the paper (batch size 4): RPi5 1.00 s per local batch
(DistilBERT) / 2.01 s (BERT); AGX Orin 6.67×/8.74× faster; Orin Nano
5.56×/6.70× faster.  These are the paper's device figures, used only to
price simulated rounds; none is a measurement of this port.
"""

from __future__ import annotations

# seconds per local batch, batch size 4
PROFILES = {
    "rpi5": {"distilbert": 1.00, "bert": 2.01},
    "orin_nano": {"distilbert": 1.00 / 5.56, "bert": 2.01 / 6.70},
    "agx_orin": {"distilbert": 1.00 / 6.67, "bert": 2.01 / 8.74},
}
BANDWIDTH = 1e6          # 1 MB/s (paper §V)

# deterministic client → device-class assignment
DEVICE_MIX = ("rpi5", "orin_nano", "agx_orin")


def device_of(cid: int) -> str:
    return DEVICE_MIX[int(cid) % len(DEVICE_MIX)]


def compute_s(cid: int, profile_name: str, n_batches: int) -> float:
    """Simulated local-training seconds for client ``cid``'s device class."""
    prof = PROFILES[device_of(cid)]
    per_batch = prof.get(profile_name, next(iter(prof.values())))
    return per_batch * n_batches
