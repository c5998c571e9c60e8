"""InternVL2-1B [arXiv:2404.16821] (reference:
``repro/configs/internvl2_1b.py``): the InternLM2-0.5B-sized language
backbone (GQA 14q/2kv, no QKV bias) behind a stubbed vision frontend: 256
precomputed patch embeddings per image, prepended to the token sequence
(``batch["prefix_embeds"]``, ``models/lm.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151_655,
    modality="vision", n_prefix_embeds=256,
    act="silu", glu=True, tie_embeddings=True, rope_theta=1e6,
    source="[arXiv:2404.16821] InternVL (InternViT + InternLM2)",
)

SMOKE = CONFIG.with_(
    name="internvl2-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512, n_prefix_embeds=8,
    layer_pattern=("attn",) * 2,
    param_dtype="float32", compute_dtype="float32", adapter_rank=4)
