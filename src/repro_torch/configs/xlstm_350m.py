"""xlstm-350m [ssm] — sLSTM + mLSTM blocks, no FFN [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,                    # per assignment: no FFN
    vocab_size=50304,
    tie_embeddings=True,
    use_rope=False,
    slstm_every=4,             # [m, m, m, s] × 6
    xlstm_proj_factor=2.0,
    # §Perf B3 (adopted): pinning inner activations model-replicated kills
    # a 6 GiB/layer all-gather GSPMD otherwise inserts (EXPERIMENTS.md §Perf)
    xlstm_pin_inner=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-350m-reduced", num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, vocab_size=512)
