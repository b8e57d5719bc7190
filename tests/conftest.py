"""Shared fixtures: tiny configs + models for CPU-speed tests.

NOTE: no XLA_FLAGS here — tests must see the real (single) CPU device; only
repro.launch.dryrun sets the 512-device placeholder count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ModelConfig
from repro.models.api import get_model


def tiny_dense(**kw):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=300,
                max_seq_len=64, lora_rank=4, remat=False)
    base.update(kw)
    return ModelConfig(**base)


def tiny_moe(**kw):
    return tiny_dense(family="moe", layer_pattern=("attn+moe",),
                      n_experts=4, n_experts_per_tok=2, d_ff_moe=96, **kw)


def tiny_ssm(**kw):
    return tiny_dense(family="ssm", layer_pattern=("mamba+none",), d_ff=0,
                      n_heads=1, n_kv_heads=1, ssm_d_state=16,
                      ssm_head_dim=16, ssm_chunk=8, use_rope=False, **kw)


@pytest.fixture(scope="session")
def dense_cfg():
    return tiny_dense()


@pytest.fixture(scope="session")
def dense_model(dense_cfg):
    m = get_model(dense_cfg)
    p = m.init(jax.random.PRNGKey(0))
    return m, p


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def rand_batch(cfg, B=2, S=16, seed=3):
    k = jax.random.PRNGKey(seed)
    toks = jax.random.randint(k, (B, S), 0, cfg.vocab_size)
    return {"tokens": toks, "loss_mask": jnp.ones((B, S), jnp.int32)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")
