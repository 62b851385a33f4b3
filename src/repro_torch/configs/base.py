"""Base configuration dataclasses for all assigned architectures.

Every architecture in the assigned pool is expressed as a ``ModelConfig``.
Family-specific extensions (MoE, MLA, SSM, enc-dec) are optional fields so a
single registry / model constructor can serve all ten architectures.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ServingConfig:
    """KV-RM serving-side configuration (paper defaults: Table 3)."""
    page_size: int = 16          # tokens per KV page
    near_window: int = 512       # W* — fixed near-window width
    farview_cap: int = 64        # cap — max far-view summary blocks
    sv_chunk: int = 128          # far-view summarization chunk size
    merge_threshold_bytes: int = 128 * 1024   # tau ~ 128 KiB
    max_hold_steps: int = 2      # delta — age cutoff for staged descriptors
    lookahead_pages: int = 1     # prefetch-1
    enable_farview: bool = False # optional policy, off by default (core path)
    skip_extent: bool = True     # work-skipping decode/prefill kernels: mask
                                 # whole out-of-extent window blocks off
                                 # (bitwise no-op; DESIGN.md §12)


@dataclass(frozen=True)
class SamplingConfig:
    """On-device sampling + data-dependent EOS (DESIGN.md §13).

    Bundles the per-run sampling policy the launcher hands to the engine
    (EngineConfig fields) and the per-request stop set it stamps on every
    submitted Request. ``greedy()`` mirrors the engine's legacy switch: the
    exact dispatch-retired budget-EOS path is kept bit-identical whenever no
    sampling knob is touched. "Greedy with stop tokens" is expressed as
    ``temperature=0`` with ``legacy=False`` — the argmax branch of the
    sampler, retired at readback like any sampled run.
    """
    temperature: float = 1.0     # <= 0 selects the exact argmax branch
    top_k: int = 0               # 0 disables the top-k filter
    top_p: float = 1.0           # 1.0 disables the nucleus filter
    seed: int = 0                # base PRNG key (threefry; folded per slot)
    stop_tokens: Tuple[int, ...] = ()   # any generated id in this set ends
                                        # the request ("stop" finish reason)
    legacy: bool = True          # True = legacy greedy budget-EOS path

    def greedy(self) -> bool:
        return self.legacy


@dataclass(frozen=True)
class ModelConfig:
    # --- identity ---
    arch_id: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    # --- common transformer dims ---
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # --- MLP ---
    mlp_act: str = "swiglu"      # swiglu | sq_relu | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0       # leading dense layers (deepseek-v3 style)
    dense_d_ff: int = 0          # d_ff of those dense layers
    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # --- SSM / hybrid (zamba2 / xlstm) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_headdim: int = 64
    shared_attn_every: int = 0   # zamba2: shared attention block period
    xlstm_pattern: Tuple[str, ...] = ()   # e.g. ('m','s','m','s',...)
    # --- encoder-decoder (seamless) ---
    enc_layers: int = 0
    dec_layers: int = 0
    cross_attention: bool = False
    # --- modality frontend (stubbed; input_specs provides embeddings) ---
    frontend: str = "none"       # none | vision_stub | audio_stub
    # --- norm ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- serving ---
    serving: ServingConfig = field(default_factory=ServingConfig)
    # --- attention semantics for long-context decode ---
    # 'dense'            : full attention over history (quadratic prefill, O(T) decode reads)
    # 'native_subquad'   : SSM/hybrid — O(1) state or bounded window natively
    sub_quadratic: bool = False

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def kv_width(self) -> int:
        """Per-token K+V width in elements for one layer (paged payload)."""
        if self.use_mla:
            # MLA pages the compressed latent: c_kv (kv_lora_rank) + decoupled rope key
            return self.kv_lora_rank + self.qk_rope_dim
        return 2 * self.n_kv_heads * self.head_dim

    @property
    def n_attn_layers(self) -> int:
        if self.family == "hybrid":
            return max(1, self.n_layers // max(1, self.shared_attn_every))
        if self.family == "ssm":
            return 0
        if self.family == "encdec":
            return self.dec_layers
        return self.n_layers

    def param_count(self) -> int:
        """Approximate total parameter count (used for MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":        # xlstm
            per = 0
            for kind in (self.xlstm_pattern or ("m",) * self.n_layers):
                if kind == "m":
                    di = self.ssm_expand * d
                    per += 2 * d * di + di * d + 3 * di * self.ssm_headdim  # up/gate/down + qkv-ish
                else:
                    per += 4 * d * d + d * (self.d_ff or 4 * d) * 2
            return per + emb
        if self.family == "hybrid":
            di = self.ssm_expand * d
            mamba_per = d * (2 * di + 2 * self.ssm_state) + di * d + di * (self.ssm_conv + 3)
            attn_per = 2 * d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
            mlp_per = 3 * d * f
            n_attn = self.n_attn_layers
            return self.n_layers * mamba_per + n_attn * (attn_per + mlp_per) // max(1, n_attn) + emb
        # attention dims
        if self.use_mla:
            attn = (d * self.q_lora_rank
                    + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = (d * self.n_heads * self.head_dim          # Q
                    + 2 * d * self.n_kv_heads * self.head_dim # K,V
                    + self.n_heads * self.head_dim * d)       # O
        gate = 3 if self.mlp_act == "swiglu" else 2
        if self.family == "moe":
            n_layers_moe = self.n_layers - self.first_k_dense
            mlp_moe = gate * d * f * (self.n_experts + self.n_shared_experts)
            mlp_dense = gate * d * (self.dense_d_ff or f)
            router = d * self.n_experts
            layers = (n_layers_moe * (attn + mlp_moe + router)
                      + self.first_k_dense * (attn + mlp_dense))
        elif self.family == "encdec":
            enc = self.enc_layers * (attn + gate * d * f)
            dec = self.dec_layers * (2 * attn + gate * d * f)  # self + cross
            layers = enc + dec
        else:
            layers = self.n_layers * (attn + gate * d * f)
        return layers + emb

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        gate = 3 if self.mlp_act == "swiglu" else 2
        n_layers_moe = self.n_layers - self.first_k_dense
        all_experts = gate * self.d_model * self.d_ff * self.n_experts * n_layers_moe
        active_experts = gate * self.d_model * self.d_ff * self.top_k * n_layers_moe
        return full - all_experts + active_experts


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str               # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}
