"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242].

38 Mamba2 layers (ssm_state=64); one *shared* transformer block (32H attn +
d_ff=8192 MLP) applied before every 6th Mamba2 layer (7 applications).
38 % 6 != 0 → the trailing group is padded with identity layers
(pad fraction reported by the JAX package, ``repro.models.hybrid``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,                 # shared block MLP
    vocab_size=32000,
    mlp_act="gelu",
    tie_embeddings=True,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    shared_attn_every=6,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-1.2b-reduced", num_layers=5, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512, ssm_state=16,
        shared_attn_every=2)
