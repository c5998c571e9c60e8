"""Zamba2-1.2B [arXiv:2411.15242] (reference:
``repro/configs/zamba2_1p2b.py``): a Mamba2 backbone with one *shared*
attention block interleaved at every 6th position, ``(5 × mamba,
shared_attn) × 6 + 2 × mamba``.  The shared block's params, its FedARA
adapters and its masks are one set reused at every occurrence
(``dec.shared`` in ``models/lm.py``); it attends through the 4096-token
sliding window (a ``local`` block)."""

from repro_torch.configs.base import ArchConfig

_PATTERN = (("mamba",) * 5 + ("shared_attn",)) * 6 + ("mamba", "mamba")

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32_000,
    layer_pattern=_PATTERN, sliding_window=4096,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    act="gelu", glu=True, tie_embeddings=True, rope_theta=10_000.0,
    source="[arXiv:2411.15242] Zamba2",
)

SMOKE = CONFIG.with_(
    name="zamba2-smoke", n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512,
    layer_pattern=("mamba", "shared_attn", "mamba", "shared_attn"),
    sliding_window=16, ssm_state=16, ssm_head_dim=32, ssm_chunk=16,
    param_dtype="float32", compute_dtype="float32", adapter_rank=4)
