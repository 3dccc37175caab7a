"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed)
[hf:microsoft/Phi-3-vision-128k-instruct].

The vision encoder + projector is a STUB per the assignment: the backbone
consumes precomputed patch+token embeddings from ``input_specs``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_act="silu",
    tie_embeddings=False,
    takes_embeddings=True,
    num_image_tokens=576,
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="phi-3-vision-4.2b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
        num_image_tokens=16)
