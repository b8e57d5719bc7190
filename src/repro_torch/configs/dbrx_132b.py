"""DBRX-132B [hf:databricks/dbrx-base]: fine-grained MoE, 16 experts,
top-4, GQA (8 kv heads); every layer is attn+moe, each expert a GLU of
width 10752."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100352, head_dim=128,
    layer_pattern=("attn+moe",),
    norm_type="layernorm", mlp_type="swiglu",
    rope_theta=500000.0, max_seq_len=32768,
    n_experts=16, n_experts_per_tok=4, d_ff_moe=10752,
    citation="hf:databricks/dbrx-base",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="dbrx-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    head_dim=32, d_ff=256, d_ff_moe=256, vocab_size=512,
    n_experts=4, n_experts_per_tok=2, max_seq_len=64)
