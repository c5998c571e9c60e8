"""Gemma3-1B [hf:google/gemma-3-1b-pt] (reference:
``repro/configs/gemma3_1b.py``): 5:1 local:global (window 512), GQA kv=1,
128k-class long context."""

from repro_torch.configs.base import ArchConfig

_PATTERN = (("local",) * 5 + ("attn",)) * 4 + ("local", "local")

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262_144,
    layer_pattern=_PATTERN, sliding_window=512,
    rms_offset=True, post_block_norm=True, embed_scale=True,
    act="gelu", glu=True, tie_embeddings=True, rope_theta=1_000_000.0,
    source="[hf:google/gemma-3-1b-pt] Gemma 3 model card",
)

SMOKE = CONFIG.with_(
    name="gemma3-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
    head_dim=32, d_ff=256, vocab_size=512,
    layer_pattern=("local", "attn"), sliding_window=16,
    param_dtype="float32", compute_dtype="float32", adapter_rank=4)
