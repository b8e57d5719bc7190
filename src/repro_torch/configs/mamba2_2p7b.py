"""Mamba2-2.7B [arXiv:2405.21060]: attention-free SSD (state-space
duality), 64 layers of mamba2 blocks, d_state 128, expand 2, head dim 64.
Decode keeps O(1) recurrent state a slot, whatever the context."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50280,
    layer_pattern=("mamba+none",),
    norm_type="rmsnorm", use_rope=False,
    ssm_d_state=128, ssm_d_conv=4, ssm_expand=2, ssm_head_dim=64,
    ssm_n_groups=1, ssm_chunk=128, max_seq_len=1048576,
    lora_targets=("in_proj", "out_proj"),
    citation="arXiv:2405.21060",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="mamba2-smoke", n_layers=2, d_model=128, vocab_size=512,
    ssm_d_state=16, ssm_head_dim=16, ssm_chunk=8, max_seq_len=64)
