"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1) [arXiv:2403.08295]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    source="arXiv:2403.08295",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_act="gelu",            # GeGLU
    tie_embeddings=True,
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma-2b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=1, head_dim=64, d_ff=512, vocab_size=512)
