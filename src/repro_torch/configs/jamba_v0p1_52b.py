"""Jamba-v0.1-52B [arXiv:2403.19887]: hybrid Mamba and attention, one
attention layer in 8, MoE (16 experts, top-2) on every other layer.  The
period of 8 holds 1 attention and 7 mamba layers, 4 of them MoE: 4
attention and 28 mamba layers in all, 16 MoE.

As in the reference, the mamba layers are SSD (Mamba-2) blocks with
d_state 16 where Jamba has Mamba-1 blocks; the attention layers carry a
4,096-token window and no RoPE."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, head_dim=128,
    layer_pattern=("mamba+mlp", "mamba+moe", "mamba+mlp", "mamba+moe",
                   "attn+mlp", "mamba+moe", "mamba+mlp", "mamba+moe"),
    norm_type="rmsnorm", mlp_type="swiglu", use_rope=False,
    sliding_window=4096,
    max_seq_len=262144,
    n_experts=16, n_experts_per_tok=2, d_ff_moe=14336,
    ssm_d_state=16, ssm_d_conv=4, ssm_expand=2, ssm_head_dim=64,
    ssm_n_groups=1, ssm_chunk=128,
    citation="arXiv:2403.19887",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="jamba-smoke", n_layers=4, d_model=256, n_heads=8, n_kv_heads=2,
    head_dim=32, d_ff=512, d_ff_moe=512, vocab_size=512,
    layer_pattern=("mamba+mlp", "mamba+moe", "attn+mlp", "mamba+moe"),
    n_experts=4, n_experts_per_tok=2, ssm_d_state=16, ssm_head_dim=16,
    ssm_chunk=8, sliding_window=16, max_seq_len=64)
