"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596].

The audio frontend is a stub: the encoder consumes precomputed frame
embeddings (``Request.enc_embeds``); only the transformer backbone (12L
encoder + 12L decoder) is modeled.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium",
    family="encdec",
    n_layers=12,             # reported depth; realized as 12 enc + 12 dec
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,             # 1024 / 16
    d_ff=4096,
    vocab_size=256206,
    enc_layers=12,
    dec_layers=12,
    cross_attention=True,
    frontend="audio_stub",
    mlp_act="gelu",
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, enc_layers=2, dec_layers=2,
    )
