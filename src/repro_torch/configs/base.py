"""Model/config system: one dataclass drives all 10 assigned architectures.

Families (DESIGN.md Sec. 6): dense / moe / ssm / hybrid / encoder / vlm /
audio. Heterogeneous layer stacks (gemma2 local-global alternation, zamba2
mamba+shared-attention interleave) are expressed as a repeating `period` of
layer kinds; parameters are stacked per period slot and the forward scans
over period groups so HLO size is depth-independent (512-device dry-run
compile economy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 64
    num_shared_experts: int = 2
    top_k: int = 6
    expert_d_ff: int = 1408
    capacity_factor: float = 1.25     # DAKC tile slack for expert dispatch
    router_aux_weight: float = 0.01   # load-balance loss
    dispatch: str = "dakc"            # 'dakc' (shard_map tiles) | 'gshard'


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    expand: int = 2
    chunk: int = 256                  # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        """The inner width: expand x d_model."""
        return self.expand * d_model


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    kind: str = "none"                # 'none' | 'vision' | 'audio'
    num_patches: int = 0              # vlm: patch embeddings per example
    frontend_dim: int = 0             # stub embedding dim (pre-projector)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|encoder|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // num_heads
    # Layer pattern: tuple of layer kinds repeated to num_layers.
    # kinds: 'attn' | 'attn_local' | 'mamba' | 'mamba_shared_attn' | 'moe'
    period: Tuple[str, ...] = ("attn",)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    sliding_window: Optional[int] = None      # for 'attn_local' kind
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    causal: bool = True                        # False: encoder (hubert)
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: FrontendConfig = FrontendConfig()
    # Execution
    scan_layers: bool = True
    remat: str = "full"               # 'none' | 'full' (scan-level remat)
    seq_parallel: bool = False        # Megatron-SP: residual seq-sharded
                                      # over 'model' between blocks
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "ref"            # 'ref' (differentiable) | 'flash'
    # DAKC integrations
    vocab_histogram: bool = False     # corpus token stats via core.ngram

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_periods(self) -> int:
        if self.num_layers % len(self.period) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"period {len(self.period)}")
        return self.num_layers // len(self.period)

    @property
    def has_decoder(self) -> bool:
        return self.causal

    @property
    def subquadratic(self) -> bool:
        """True iff no layer kind does full (unwindowed) global attention --
        the long_500k eligibility rule (DESIGN.md Sec. 6)."""
        for kind in self.period:
            if kind in ("attn", "moe"):     # moe blocks use full attention
                return False
            if kind == "attn_local" and self.sliding_window is None:
                return False
            if kind == "mamba_shared_attn" and self.sliding_window is None:
                return False
        return True

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS = 6*N*D and memory planning."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d * (1 if self.tie_embeddings else 2)
        per_kind = {}
        for kind in self.period:
            n = per_kind.get(kind, 0)
            per_kind[kind] = n + 1
        reps = self.num_periods
        for kind, cnt in per_kind.items():
            cnt *= reps
            if kind in ("attn", "attn_local"):
                attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                    + self.num_heads * hd * d
                total += cnt * (attn + 3 * d * self.d_ff + 2 * d)
            elif kind == "mamba":
                total += cnt * self._mamba_params()
            elif kind == "mamba_shared_attn":
                total += cnt * self._mamba_params()
            elif kind == "moe":
                m = self.moe
                attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                    + self.num_heads * hd * d
                experts = (m.num_experts + m.num_shared_experts) \
                    * 3 * d * m.expert_d_ff
                total += cnt * (attn + experts + d * m.num_experts + 2 * d)
        if "mamba_shared_attn" in per_kind:
            # one shared attention block (+MLP), counted once
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * hd * d
            total += attn + 3 * d * self.d_ff
        return total

    def _mamba_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_in = s.d_inner(d)
        n_heads = d_in // s.headdim
        return (d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)  # in_proj
                + s.conv_width * (d_in + 2 * s.n_groups * s.d_state)   # conv
                + 2 * n_heads                                          # A, D
                + d_in * d)                                            # out_proj

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        n_moe_layers = sum(1 for k in self.period if k == "moe") \
            * self.num_periods
        inactive = n_moe_layers * (m.num_experts - m.top_k) \
            * 3 * self.d_model * m.expert_d_ff
        return full - inactive


# --- Input shape cells (assigned set) ---------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig):
    """The (arch x shape) applicability rules from the assignment."""
    out = {}
    for name, cell in SHAPES.items():
        if cell.kind == "decode" and not cfg.has_decoder:
            out[name] = (False, "encoder-only: no decode step")
        elif name == "long_500k" and not cfg.subquadratic:
            out[name] = (False, "full attention is quadratic at 500k")
        elif name == "long_500k" and not cfg.has_decoder:
            out[name] = (False, "encoder-only: no decode step")
        else:
            out[name] = (True, "")
    return out
