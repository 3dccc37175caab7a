"""whisper-tiny [audio] — enc-dec, conv/mel frontend stubbed [arXiv:2212.04356].

The encoder consumes precomputed frame embeddings [B, 1500, 384] from
``input_specs`` (the mel+conv frontend is the assignment's allowed stub).
Decoder positions are sinusoidal (deviation; see DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=4,              # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    mlp_act="gelu_plain",
    tie_embeddings=True,
    use_rope=False,
    is_encoder_decoder=True,
    enc_layers=4,
    enc_seq=1500,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-tiny-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512, enc_layers=2,
        enc_seq=64)
