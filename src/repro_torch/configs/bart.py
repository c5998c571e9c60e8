"""BART-base [Lewis et al. 2020] (reference: ``repro/configs/bart.py``) —
the paper's summarization model: an encoder-decoder whose decoder blocks
cross-attend to the encoder's output."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="bart", family="encdec",
    n_layers=6, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=50_265,
    is_encoder_decoder=True, n_encoder_layers=6,
    norm="layernorm", pos_emb="learned", act="gelu", glu=False,
    tie_embeddings=True, max_position=1024, adapter_rank=12,
    param_dtype="float32", compute_dtype="float32",
    source="[ACL'20] BART",
)

MINI = CONFIG.with_(
    name="bart-mini", n_layers=2, n_encoder_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=2048,
    layer_pattern=("attn",) * 2, max_position=128, adapter_rank=8)

SMOKE = MINI.with_(name="bart-smoke", adapter_rank=4)
