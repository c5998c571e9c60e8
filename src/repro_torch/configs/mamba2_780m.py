"""Mamba2-780M [arXiv:2405.21060] (reference:
``repro/configs/mamba2_780m.py``): attention-free SSD (state-space
duality), 48 layers, d_model 1536 (d_inner 3072, 48 heads × 64), d_state
128.  The paper's adapters attach to the in/out projections
(``models/ssm.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50_280,
    layer_pattern=("mamba",) * 48,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    pos_emb="none", act="silu", glu=False, tie_embeddings=True,
    adapter_targets=("w1", "w2"),
    source="[arXiv:2405.21060] Mamba2 / SSD",
)

SMOKE = CONFIG.with_(
    name="mamba2-smoke", n_layers=2, d_model=128, vocab_size=512,
    layer_pattern=("mamba",) * 2, ssm_state=16, ssm_head_dim=32,
    ssm_chunk=16,
    param_dtype="float32", compute_dtype="float32", adapter_rank=4)
