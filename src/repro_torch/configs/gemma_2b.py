"""Gemma-2B [arXiv:2403.08295]: GeGLU MLP, head_dim 256, MQA (one kv
head), tied embeddings with √d input scaling, a 256,000-entry vocabulary."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=256000, head_dim=256,
    norm_type="rmsnorm", mlp_type="geglu", tie_embeddings=True,
    rope_theta=10000.0, max_seq_len=8192,
    citation="arXiv:2403.08295",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="gemma-smoke", n_layers=2, d_model=256, n_heads=4, n_kv_heads=1,
    head_dim=64, d_ff=512, vocab_size=512, max_seq_len=64)
