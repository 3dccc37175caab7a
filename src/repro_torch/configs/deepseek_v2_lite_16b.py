"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434].

Assignment-line note: the bracket text says "160 routed" (the V2-236B
figure); the structured spec says "MoE 64e top-6" which matches the actual
V2-Lite — we follow the structured spec (see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,              # v_head_dim; qk = nope 128 + rope 64
    d_ff=0,
    vocab_size=102400,
    mlp_act="silu",
    tie_embeddings=False,
    attn_kind="mla",
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v2-lite-16b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=32, vocab_size=512,
        kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
        num_experts=4, num_shared_experts=1, top_k=2, moe_d_ff=128)
