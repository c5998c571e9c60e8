"""Kimi K2 (1T total / 32B active) [arXiv:2501.kimi2, paper-table entry]
(reference: ``repro/configs/kimi_k2_1t_a32b.py``): 61 layers, d_model
7168, GQA 64q/8kv, MoE with 384 experts (top-8, expert d_ff 2048).  The
frozen base is ~1.03T params (≈2.06 TB bf16), more than one card holds:
the port runs its SMOKE variant."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163_840,
    layer_pattern=("moe",) * 61,
    n_experts=384, top_k=8, capacity_factor=1.25,
    act="silu", glu=True, tie_embeddings=True, rope_theta=50_000.0,
    source="[arXiv:2501.kimi2] Kimi K2 (paper-table)",
)

SMOKE = CONFIG.with_(
    name="kimi-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=64, vocab_size=512, layer_pattern=("moe",) * 2,
    n_experts=4, top_k=2, capacity_factor=2.0,
    param_dtype="float32", compute_dtype="float32", adapter_rank=4)
