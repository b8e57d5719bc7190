"""InternVL2-26B [arXiv:2404.16821]: a vision-language model, the
InternLM2-20B language backbone (GQA 48/8, SwiGLU, RMSNorm) reading 256
image-patch embeddings prepended to the text.  The vision encoder and
projector are a stub, as in the reference: callers pass the patch
embeddings (B, 256, d) themselves."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92553, head_dim=128,
    norm_type="rmsnorm", mlp_type="swiglu",
    rope_theta=1000000.0, max_seq_len=32768,
    n_patch_tokens=256,
    citation="arXiv:2404.16821",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="internvl2-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    head_dim=32, d_ff=512, vocab_size=512, n_patch_tokens=8, max_seq_len=64)
