"""BERT-base [Devlin et al. 2019] (reference: ``repro/configs/bert.py``) —
the paper's second evaluation classifier: DistilBERT's features at 12
layers."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="bert", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=30_522,
    norm="layernorm", pos_emb="learned", act="gelu", glu=False,
    causal=False,
    tie_embeddings=True, n_classes=20, max_position=512,
    adapter_rank=12,
    param_dtype="float32", compute_dtype="float32",
    source="[NAACL'19] BERT",
)

MINI = CONFIG.with_(
    name="bert-mini", n_layers=6, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=2048, adapter_rank=12,
    layer_pattern=("attn",) * 6, max_position=128)

SMOKE = MINI.with_(name="bert-smoke", n_layers=2,
                   layer_pattern=("attn",) * 2, adapter_rank=4)
