"""Architecture configuration schema for every supported model family."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    version: int            # 1 = Mamba1 (falcon-mamba), 2 = Mamba2/SSD
    state: int
    expand: int = 2         # d_inner = expand * d_model
    conv_width: int = 4
    head_dim: int = 64      # Mamba2 only
    dt_rank: int = 0        # 0 => ceil(d_model/16) (Mamba1 default)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid_period: int = 0            # zamba: shared attn block every k layers
    modality: str = "text"            # text | audio_stub | vision_stub
    # dry-run / training knobs (overridable per shape cell)
    remat: bool = True
    attn_q_chunk: int = 512
    loss_chunk: int = 2048
    scan_layers: bool = True
    ssm_chunk: int = 256
    seq_parallel: bool = True    # shard inter-layer hidden over model axis
    kv_quant: bool = False       # int8 KV cache (decode): per-token/head scales

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM state or hybrid)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str               # train_4k | prefill_32k | decode_32k | long_500k
    kind: str               # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
