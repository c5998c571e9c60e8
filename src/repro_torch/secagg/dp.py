"""Client-level DP-FedAvg (McMahan et al. '18) + subsampled-Gaussian RDP
(reference: ``repro/secagg/dp.py``, a numpy copy).

Per-round mechanism on the *client delta* wire vector:
  1. each client clips its delta to L2 norm ≤ C (``clip_to_norm``),
  2. contributions are averaged with uniform weights (weighted averaging
     would make per-client sensitivity data-dependent),
  3. the server adds N(0, (z·C)² I) to the *sum* before dividing by the
     reporting count.

The accountant composes Rényi DP of the subsampled Gaussian mechanism
(sampling rate q = cohort/population) across rounds using the integer-order
bound of Mironov et al. '19 (arXiv 1908.10530):

    RDP(α) = log( Σ_{k=0..α} C(α,k)·(1−q)^{α−k}·q^k·e^{k(k−1)/(2σ²)} ) / (α−1)

which collapses to the plain Gaussian α/(2σ²) at q = 1 — the closed form the
tests spot-check — and converts to (ε, δ) with ε = min_α RDP·T + ln(1/δ)/(α−1).

Noise is drawn host-side after decoding (central-DP simulation), from
numpy's ``default_rng`` streams as the reference draws it, so a run's noise
is the reference's bit for bit; distributed noise inside the field (so the
*server* never sees a noiseless aggregate) is not simulated.
"""

from __future__ import annotations

import math

import numpy as np

DEFAULT_ORDERS = tuple(range(2, 65)) + (80, 96, 128, 192, 256)


def clip_to_norm(vec: np.ndarray, clip: float) -> tuple[np.ndarray, float]:
    """Scale ``vec`` to L2 norm ≤ clip; returns (clipped, original_norm)."""
    w = np.asarray(vec, np.float32)
    norm = float(np.linalg.norm(w))
    if clip <= 0 or norm <= clip:
        return w, norm
    return (w * (clip / norm)).astype(np.float32), norm


def gaussian_sum_noise(n: int, clip: float, noise_multiplier: float,
                       rng: np.random.Generator) -> np.ndarray:
    """Noise for the *sum* of clipped contributions: std = z·C per element."""
    if noise_multiplier <= 0 or clip <= 0:
        return np.zeros((n,), np.float32)
    return rng.normal(0.0, noise_multiplier * clip, size=n).astype(np.float32)


def _log_binom(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def rdp_subsampled_gaussian(q: float, sigma: float,
                            orders=DEFAULT_ORDERS) -> np.ndarray:
    """Per-round RDP at each integer order for sampling rate q, noise σ."""
    if sigma <= 0:
        return np.full(len(orders), np.inf)
    if q <= 0:
        return np.zeros(len(orders))
    out = []
    for a in orders:
        a = int(a)
        if q >= 1.0:
            out.append(a / (2.0 * sigma * sigma))
            continue
        # log-sum-exp over the binomial expansion's α+1 terms
        logs = []
        for k in range(a + 1):
            logs.append(_log_binom(a, k)
                        + (a - k) * math.log1p(-q)
                        + (k * math.log(q) if k else 0.0)
                        + k * (k - 1) / (2.0 * sigma * sigma))
        m = max(logs)
        lse = m + math.log(sum(math.exp(x - m) for x in logs))
        out.append(lse / (a - 1))
    return np.asarray(out, np.float64)


class RDPAccountant:
    """Composes ε(δ) across federated rounds for one (z, q) mechanism."""

    def __init__(self, noise_multiplier: float, sample_rate: float,
                 orders=DEFAULT_ORDERS):
        self.noise_multiplier = float(noise_multiplier)
        self.sample_rate = float(min(max(sample_rate, 0.0), 1.0))
        self.orders = np.asarray([int(a) for a in orders], np.int64)
        self._per_round = rdp_subsampled_gaussian(
            self.sample_rate, self.noise_multiplier, self.orders)
        self.rounds = 0

    def step(self, n_rounds: int = 1) -> None:
        self.rounds += int(n_rounds)

    def epsilon(self, delta: float = 1e-5) -> float:
        """min over orders of RDP·T + ln(1/δ)/(α−1)."""
        if self.noise_multiplier <= 0:
            return float("inf")
        if self.rounds == 0:
            return 0.0
        eps = self._per_round * self.rounds \
            + math.log(1.0 / delta) / (self.orders - 1)
        return float(np.min(eps))
