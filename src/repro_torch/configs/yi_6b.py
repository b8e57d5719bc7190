"""Yi-6B [arXiv:2403.04652]: the llama architecture with GQA (4 kv heads),
SwiGLU, RMSNorm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab_size=64000, head_dim=128,
    norm_type="rmsnorm", mlp_type="swiglu",
    rope_theta=5000000.0, max_seq_len=4096,
    citation="arXiv:2403.04652",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="yi-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    head_dim=32, d_ff=512, vocab_size=512, max_seq_len=64)
