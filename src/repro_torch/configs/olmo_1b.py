"""OLMo-1B [arXiv:2402.00838]: MHA (16 kv heads), non-parametric LayerNorm
(no affine parameters), SwiGLU, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=50304, head_dim=128,
    norm_type="nonparametric", mlp_type="swiglu", tie_embeddings=True,
    rope_theta=10000.0, max_seq_len=4096,
    citation="arXiv:2402.00838",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="olmo-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
    head_dim=32, d_ff=512, vocab_size=512, max_seq_len=64)
