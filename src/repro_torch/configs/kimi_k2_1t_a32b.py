"""Kimi-K2 1T-A32B [arXiv:2501.kimi2]: trillion-parameter fine-grained
MoE, 384 experts, top-8, expert width 2048, GQA (8 kv heads), 61 layers.
As in the reference: head_dim 128 (7168 / 64 = 112 is not tile aligned),
and the real model's first dense layer and shared expert folded into the
attn+moe pattern."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, head_dim=128,
    layer_pattern=("attn+moe",),
    norm_type="rmsnorm", mlp_type="swiglu",
    rope_theta=1000000.0, max_seq_len=131072,
    n_experts=384, n_experts_per_tok=8, d_ff_moe=2048,
    moe_capacity_factor=1.25,
    citation="arXiv:2501.kimi2",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="kimi-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    head_dim=32, d_ff=128, d_ff_moe=128, vocab_size=512,
    n_experts=4, n_experts_per_tok=2, max_seq_len=64)
