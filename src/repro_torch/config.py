"""Config system for the PyTorch port (own copy of ``repro.config``).

Every architecture is described by an :class:`ArchConfig` dataclass and
registered in ``repro_torch.configs``.  The classes are plain frozen
dataclasses with no framework dependency, so the port keeps its own copy
instead of importing the JAX package.  Only the serving and training
slices' architecture (internlm2-1.8b) is registered so far; the shape
cells (``SHAPES``) are the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Block kinds (layer-pattern vocabulary)
# ---------------------------------------------------------------------------
ATTN = "attn"            # full softmax attention (GQA/MQA/MHA)
ATTN_LOCAL = "attn_local"  # sliding-window attention
ATTN_MLA = "attn_mla"    # DeepSeek multi-head latent attention
MAMBA = "mamba"          # selective SSM block
RWKV = "rwkv"            # RWKV6 time-mix block
DENSE_FF = "ff"          # dense (possibly gated) FFN
MOE_FF = "moe"           # routed mixture-of-experts FFN


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    num_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64
    gate_lora: int = 32


@dataclass(frozen=True)
class ArchConfig:
    """Architecture description (field-for-field the JAX package's)."""

    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 for attn-free archs)
    num_kv_heads: int
    d_ff: int                       # dense FFN intermediate size
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # the stack is ``prefix_pattern`` followed by N periods of
    # ``layer_pattern``; N = (num_layers - len(prefix)) / len(pattern)
    layer_pattern: Tuple[Tuple[str, str], ...] = ((ATTN, DENSE_FF),)
    prefix_pattern: Tuple[Tuple[str, str], ...] = ()

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None

    window_size: int = 0            # 0 -> no local attention layers
    encoder_layers: int = 0
    encoder_seq_len: int = 0
    vision_tokens: int = 0

    rope_theta: float = 10_000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    gated_ffn: bool = True          # SwiGLU-style if True, GELU MLP otherwise
    dtype: str = "bfloat16"
    remat: bool = True
    fsdp: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def num_periods(self) -> int:
        n = self.num_layers - len(self.prefix_pattern)
        if n % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: {n} scanned layers not divisible by period "
                f"{len(self.layer_pattern)}")
        return n // len(self.layer_pattern)

    def layer_kinds(self) -> List[Tuple[str, str]]:
        """Expanded per-layer (mixer, ffn) kinds, length == num_layers."""
        out: List[Tuple[str, str]] = list(self.prefix_pattern)
        out.extend(list(self.layer_pattern) * self.num_periods)
        assert len(out) == self.num_layers
        return out

    def param_count(self) -> int:
        """Analytic parameter count of a dense attention stack
        (embedding + blocks + head)."""
        d = self.d_model
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = (d * self.num_heads * self.head_dim
                + 2 * d * self.num_kv_heads * self.head_dim
                + self.num_heads * self.head_dim * d)
        ffn = (3 if self.gated_ffn else 2) * d * self.d_ff
        return total + self.num_layers * (attn + ffn + 2 * d)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _ensure_loaded() -> None:
    # configs register themselves on import
    import repro_torch.configs  # noqa: F401


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """A reduced config of the same family for CPU smoke tests (the same
    reduction as the JAX package's, so both build identical shapes)."""
    changes: Dict[str, Any] = dict(
        name=cfg.name + "-smoke",
        num_layers=len(cfg.prefix_pattern) + max(2, len(cfg.layer_pattern)) if
        len(cfg.layer_pattern) > 1 or cfg.prefix_pattern else 2,
        d_model=64,
        d_ff=128,
        vocab_size=257,
        head_dim=16 if cfg.num_heads else 0,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        window_size=min(cfg.window_size, 8) if cfg.window_size else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq_len=16 if cfg.encoder_seq_len else 0,
        vision_tokens=4 if cfg.vision_tokens else 0,
        remat=False,
        fsdp=False,
    )
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            num_experts=4, num_experts_per_tok=2,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            expert_d_ff=32)
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(kv_lora_rank=16, q_lora_rank=24,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16)
    if cfg.mamba is not None:
        changes["mamba"] = MambaConfig(d_state=4, d_conv=2, expand=2,
                                       dt_rank=4)
    if cfg.rwkv is not None:
        changes["rwkv"] = RWKVConfig(head_size=16, decay_lora=8, gate_lora=8)
    return dataclasses.replace(cfg, **changes)
