"""minitron-4b [dense] — pruned Nemotron, squared-ReLU MLP [arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    source="arXiv:2407.14679",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    mlp_act="relu2",           # Nemotron squared-ReLU (non-gated)
    tie_embeddings=False,
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="minitron-4b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512)
