"""Qwen2-0.5B [arXiv:2407.10671] (reference: ``repro/configs/qwen2_0p5b.py``):
dense decoder, GQA (14q/2kv), QKV bias."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151_936,
    qkv_bias=True, rope_theta=1e6, act="silu", glu=True,
    tie_embeddings=True,
    source="[arXiv:2407.10671] Qwen2 Technical Report",
)

SMOKE = CONFIG.with_(
    name="qwen2-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512, layer_pattern=("attn",) * 2,
    param_dtype="float32", compute_dtype="float32", adapter_rank=4)
