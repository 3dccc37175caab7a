"""Model configuration schema shared by all assigned architectures.

Every architecture in ``repro_torch/configs/<id>.py`` instantiates :class:`ModelConfig`
with the exact assigned dimensions and provides a ``reduced()`` variant
(≤2 layers, d_model ≤ 512, ≤4 experts) for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | ssm | hybrid | audio
    source: str                     # citation (arXiv id / model card)

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- MLP / norm flavour ---
    mlp_act: str = "silu"           # silu->SwiGLU, gelu->GeGLU, gelu_plain->MLP
    use_qk_norm: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # --- attention flavour ---
    attn_kind: str = "gqa"          # gqa | mla | none
    use_rope: bool = True
    rope_theta: float = 10000.0
    window: int = 0                 # 0 = full causal; >0 = sliding window

    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mla_absorbed: bool = False      # decode-path weight absorption (§Perf)

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    moe_bf16_combine: bool = False  # bf16 expert-combine psum (§Perf)

    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_heads: int = 0              # number of SSD heads (derived if 0)

    # --- xLSTM ---
    slstm_every: int = 0            # every k-th layer is an sLSTM block
    xlstm_proj_factor: float = 2.0
    xlstm_pin_inner: bool = False   # pin inner acts model-replicated (§Perf)

    # --- hybrid (Zamba2) ---
    shared_attn_every: int = 0      # shared attn block before every k-th layer

    # --- encoder-decoder (Whisper) ---
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500             # conv-frontend output frames (stubbed)

    # --- VLM ---
    takes_embeddings: bool = False  # inputs are embeddings, not token ids
    num_image_tokens: int = 0

    # --- numerics ---
    dtype: str = "bfloat16"

    # --- distribution knobs (set by the launchers, not per-arch) ---
    seq_parallel: bool = False      # Megatron-SP residual stream (train)
    loss_chunk: int = 0             # sequence-chunked xent (0 = off)

    # ------------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return max(self.num_heads // max(self.num_kv_heads, 1), 1)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        # headdim 64 convention
        return max(self.d_inner // 64, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_window(self, window: int) -> "ModelConfig":
        """Sliding-window variant (used by dense archs for long_500k)."""
        return self.replace(window=window, name=f"{self.name}-swa{window}")


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch, mode) workload shape."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES: dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def reduced_shape(shape: InputShape, seq_len: int = 64,
                  global_batch: int = 2) -> InputShape:
    return InputShape(f"{shape.name}-reduced", seq_len, global_batch, shape.mode)
