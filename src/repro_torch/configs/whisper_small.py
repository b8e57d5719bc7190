"""Whisper-small [arXiv:2212.04356]: an encoder-decoder (12 + 12 layers)
with learned positions, pre-LayerNorm with bias, a GELU MLP without a
gate and a tied unembedding.  The mel and convolution frontend is a stub,
as in the reference: callers pass the 1,500 frame embeddings (B, 1500, d)
themselves.  LoRA on q, v and the MLP, the usual choice for Whisper."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=51865,
    norm_type="layernorm", mlp_type="gelu", use_rope=False,
    tie_embeddings=True,
    n_encoder_layers=12, encoder_seq_len=1500,
    # the real decoder context is 448; the reference widens it to 32768
    max_seq_len=32768,
    lora_targets=("wq", "wv", "w_up", "w_out"),
    citation="arXiv:2212.04356",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="whisper-smoke", n_layers=2, n_encoder_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512, encoder_seq_len=32,
    max_seq_len=64)
