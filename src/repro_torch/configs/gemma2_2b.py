"""Gemma2-2B [arXiv:2408.00118] (reference: ``repro/configs/gemma2_2b.py``):
1:1 local:global attention alternation, logit soft-capping, pre+post block
norms, GeGLU."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256_000,
    layer_pattern=("local", "attn") * 13,
    sliding_window=4096, attn_softcap=50.0, final_softcap=30.0,
    rms_offset=True, post_block_norm=True, embed_scale=True,
    act="gelu", glu=True, tie_embeddings=True, rope_theta=10_000.0,
    source="[arXiv:2408.00118] Gemma 2",
)

SMOKE = CONFIG.with_(
    name="gemma2-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512,
    layer_pattern=("local", "attn"), sliding_window=16,
    param_dtype="float32", compute_dtype="float32", adapter_rank=4)
