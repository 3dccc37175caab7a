"""deepseek-moe-16b [moe] — fine-grained: 2 shared + 64 routed top-6, GQA
[arXiv:2401.06066].

Deviation from the released checkpoint (noted in DESIGN.md): the real model's
first layer is dense; we keep all layers MoE for scan homogeneity.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=102400,
    mlp_act="silu",
    tie_embeddings=False,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-moe-16b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=64, vocab_size=512,
        num_experts=4, num_shared_experts=1, top_k=2, moe_d_ff=128)
