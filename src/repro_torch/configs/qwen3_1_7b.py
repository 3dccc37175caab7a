"""qwen3-1.7b [dense] — qk-norm, GQA kv=8 [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    mlp_act="silu",
    use_qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-1.7b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512)
