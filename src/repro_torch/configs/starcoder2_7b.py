"""starcoder2-7b [dense] — GQA kv=4, RoPE, plain-GELU MLP [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    source="arXiv:2402.19173",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    mlp_act="gelu_plain",
    tie_embeddings=False,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="starcoder2-7b-reduced", num_layers=2, d_model=288,
        num_heads=4, num_kv_heads=2, head_dim=72, d_ff=576, vocab_size=512)
