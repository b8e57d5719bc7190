"""StarCoder2-15B [arXiv:2402.19173]: GQA (4 kv heads), RoPE, LayerNorm
with bias, a GELU MLP without a gate, and a 4,096-token sliding window."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab_size=49152, head_dim=128,
    norm_type="layernorm", mlp_type="gelu", use_rope=True,
    rope_theta=100000.0, sliding_window=4096, max_seq_len=16384,
    citation="arXiv:2402.19173",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="starcoder2-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    head_dim=32, d_ff=512, vocab_size=512, sliding_window=16, max_seq_len=64)
