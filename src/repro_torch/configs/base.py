"""Architecture configuration dataclass (reference: ``repro/configs/base.py``).

Same fields and derived properties as the JAX ``ArchConfig``; ``pdtype`` and
``cdtype`` map the dtype names onto torch dtypes instead of ``jnp.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

BlockKind = Literal["attn", "local", "moe", "local_moe", "mamba", "shared_attn"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype name {name!r}") from None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""                   # citation [arXiv:....]

    head_dim: int = 0                  # 0 → d_model // n_heads
    layer_pattern: tuple[BlockKind, ...] = ()   # len == n_layers; () → all "attn"

    # attention features
    sliding_window: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qkv_bias: bool = False
    causal: bool = True
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"              # rope | learned | sinusoidal | none
    max_position: int = 1 << 20

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.5
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # modality stubs
    modality: str = "text"
    n_prefix_embeds: int = 0

    # norms / activations / embeddings
    norm: str = "rmsnorm"
    rms_offset: bool = False
    post_block_norm: bool = False
    act: str = "silu"
    glu: bool = True
    tie_embeddings: bool = True
    embed_scale: bool = False

    # classification head
    n_classes: int = 0

    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # PEFT policy (the paper's technique)
    adapter_targets: tuple[str, ...] = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
    adapter_rank: int = 8
    adapter_alpha: float = 16.0

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.layer_pattern:
            kind: BlockKind = "attn"
            if self.family == "moe":
                kind = "moe"
            elif self.family == "ssm":
                kind = "mamba"
            object.__setattr__(self, "layer_pattern", (kind,) * self.n_layers)
        if len(self.layer_pattern) != self.n_layers:
            raise ValueError(
                f"{self.name}: layer_pattern has {len(self.layer_pattern)} "
                f"entries for n_layers={self.n_layers}")

    # ---- derived -----------------------------------------------------------
    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
