"""MiniCPM-2B [arXiv:2404.06395] (reference: ``repro/configs/minicpm_2b.py``):
llama-like dense decoder (36 query heads over 36 kv heads: MHA), trained
with the WSD schedule (``repro_torch.optim.schedules.wsd``).  As in the
reference, no MiniCPM-specific model code: no embedding, depth or logit
scaling."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab_size=122_753,
    act="silu", glu=True, tie_embeddings=True, rope_theta=10_000.0,
    source="[arXiv:2404.06395] MiniCPM",
)

SMOKE = CONFIG.with_(
    name="minicpm-smoke", n_layers=2, d_model=144, n_heads=4, n_kv_heads=4,
    head_dim=36, d_ff=288, vocab_size=512, layer_pattern=("attn",) * 2,
    param_dtype="float32", compute_dtype="float32", adapter_rank=4)
