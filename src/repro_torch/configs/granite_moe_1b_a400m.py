"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]
(reference: ``repro/configs/granite_moe_1b_a400m.py``): 24-layer MoE, 32
experts top-8 with narrow (512) expert FFNs."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49_155,
    layer_pattern=("moe",) * 24,
    n_experts=32, top_k=8, capacity_factor=1.5,
    act="silu", glu=True, tie_embeddings=True, rope_theta=10_000.0,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base] model card",
)

SMOKE = CONFIG.with_(
    name="granite-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=64, vocab_size=512, layer_pattern=("moe",) * 2,
    n_experts=4, top_k=2, capacity_factor=2.0,
    param_dtype="float32", compute_dtype="float32", adapter_rank=4)
