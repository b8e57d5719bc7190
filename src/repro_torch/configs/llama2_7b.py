"""LLaMA2-7B [arXiv:2307.09288], the FDLoRA paper's own backbone (§4.1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab_size=32000, head_dim=128,
    norm_type="rmsnorm", mlp_type="swiglu",
    rope_theta=10000.0, max_seq_len=4096,
    citation="arXiv:2307.09288",
)

# max_seq_len 160 (the reference's smoke config has 64) so that a
# ``launch.train --smoke`` batch holds the answer tokens of the synthetic
# log prompts (about 90 bytes) and its loss is not empty
SMOKE_CONFIG = CONFIG.with_overrides(
    name="llama2-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
    head_dim=32, d_ff=512, vocab_size=512, max_seq_len=160)
