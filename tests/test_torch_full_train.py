"""Full fine-tuning (``make_full_train_step``) through the port against the
reference package on the CPU.

Every family the reference's step serves (dense, MoE, SSM, hybrid, VLM,
encoder-decoder, on the tiny configs the other port tests narrow them
to): the loss and every weight's gradient, then the weights after three
AdamW steps; ten steps at the shape the reference's benchmark harness
pretrains its base with; the step walked on the meta device at
llama2-7b's full width (flash attention in every layer, no LoRA kernel);
``"cuda"`` refused on CPU tensors.  Weights come from the reference init,
bridged; batches are numpy-seeded; everything is fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense, tiny_moe, tiny_ssm
from repro.data.synthetic import gen_log_dataset, gen_pretrain_text
from repro.data.tokenizer import ByteTokenizer, pad_batch
from repro.models.api import get_model
from repro.training import optimizers as j_opt
from repro.training import train_step as j_ts
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.lora import tree_leaves
from repro_torch.kernels import WRAPPERS
from repro_torch.launch import dryrun
from repro_torch.models.api import Model
from repro_torch.training import optimizers
from repro_torch.training.train_step import (full_value_and_grad,
                                             make_full_train_step)

# fp32 on both sides from the same inputs: only summation order differs
# (tests/test_torch_training.py's bounds)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5


# Weights after AdamW steps, per leaf: ||p_port - p_ref|| within 1e-2 of
# the leaf's own travel ||p_ref - p_0||, and every element within lr per
# step.  Adam divides by sqrt(v) + eps, so an element whose gradient lands
# near eps carries its fp32 summation noise into an update of up to lr:
# among the 0.1-0.4 M weights of each case here, the VLM's has one whose
# first gradient is 1e-8 (3e-6 of the rms, a cancellation) and moves 8%
# of lr apart, where tests/test_torch_training.py's 1e-2 of lr per step
# holds for adapters.  Every other element of the six cases stays inside
# that, and every leaf within 1e-3 of its travel.
TRAVEL_TOL = 1e-2


def _assert_steps_close(port, jtree, p0, lr: float, steps: int):
    got = dict(tree_leaves(port))
    want = dict(tree_leaves(bridge.params_from_jax(_np(jtree),
                                                   device="cpu")))
    start = dict(tree_leaves(p0))
    assert got.keys() == want.keys()
    for path in got:
        diff = got[path] - want[path]
        travel = torch.linalg.vector_norm(want[path] - start[path])
        assert float(torch.linalg.vector_norm(diff)) <= TRAVEL_TOL * float(
            travel), path
        assert float(diff.abs().max()) <= lr * steps, path


CASES = {
    "tiny_dense": lambda: tiny_dense(),
    "tiny_moe": lambda: tiny_moe(),
    "tiny_ssm": lambda: tiny_ssm(),
    # the hybrid of tests/test_models.py, as tests/test_torch_ssm.py
    "tiny_hybrid": lambda: tiny_dense(
        name="hy", family="hybrid",
        layer_pattern=("mamba+mlp", "mamba+moe", "attn+mlp", "mamba+moe"),
        n_layers=4, n_experts=4, n_experts_per_tok=2, ssm_d_state=16,
        ssm_head_dim=16, ssm_chunk=8),
    # the vlm and encdec configs of tests/test_models.py, as
    # tests/test_torch_vlm_encdec.py
    "vlm": lambda: tiny_dense(name="vlm", family="vlm", n_patch_tokens=8),
    "encdec": lambda: tiny_dense(
        name="ed", family="encdec", n_kv_heads=4, norm_type="layernorm",
        mlp_type="gelu", use_rope=False, tie_embeddings=True,
        n_encoder_layers=2, encoder_seq_len=24,
        lora_targets=("wq", "wv", "w_up", "w_out")),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small torch ops under the suite's worker processes: one intra-op
    thread for this file (as tests/test_torch_ssm.py), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setups():
    """name -> (jcfg, jax model, jax params, port cfg, port model, port
    params), fp32, built once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg = CASES[name]().with_overrides(
                dtype="float32", param_dtype="float32", remat=False)
            jm = get_model(jcfg)
            jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
            pcfg = bridge.config_from_jax(jcfg)
            cache[name] = (jcfg, jm, jp, pcfg, Model(pcfg, device="cpu"),
                           bridge.params_from_jax(_np(jp), device="cpu"))
        return cache[name]
    return get


def _batch(jcfg, seed, B=2, S=16):
    """Tokens, a loss mask and the family's stub embeddings (numpy)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": (rng.random((B, S)) < 0.7).astype(np.int32)}
    if jcfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, jcfg.n_patch_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.is_encdec:
        b["enc_embeds"] = rng.standard_normal(
            (B, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
    return b


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_grads_close(port, jtree, atol, rtol=1e-4):
    """Port gradients against a reference tree (stacked on the period
    axis), bridged to the port's layout."""
    got = dict(tree_leaves(port))
    want = dict(tree_leaves(bridge.params_from_jax(_np(jtree),
                                                   device="cpu")))
    assert got.keys() == want.keys()
    for path in got:
        np.testing.assert_allclose(got[path].detach().numpy(),
                                   want[path].numpy(), atol=atol, rtol=rtol,
                                   err_msg=path)


@pytest.mark.parametrize("name", list(CASES))
def test_full_step_loss_and_gradients_match_reference(setups, name):
    """The reference's own full step under SGD at lr 1 with no clip moves
    every weight by exactly minus its gradient: those gradients against
    the port's, leaf by leaf, with the loss and its metrics."""
    jcfg, jm, jp, pcfg, pm, pp = setups(name)
    b = _batch(jcfg, 1)
    jstep = jax.jit(j_ts.make_full_train_step(jm, jcfg, j_opt.sgd(lr=1.0),
                                              clip_norm=0.0))
    jnew, _, jmet = jstep(jp, {}, _jb(b))
    jg = jax.tree.map(lambda p, q: np.asarray(p) - np.asarray(q), jp, jnew)
    loss, met, grads = full_value_and_grad(pm, pcfg)(pp, _tb(b))
    if not pcfg.has_moe():                  # no aux loss in the total
        assert float(loss) == float(met["loss"])
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                               abs=LOSS_TOL)
    assert float(met["accuracy"]) == pytest.approx(float(jmet["accuracy"]))
    assert float(met["tokens"]) == float(jmet["tokens"])
    _assert_grads_close(grads, jg, atol=GRAD_TOL)
    # every weight of the model trains
    assert all(float(g.abs().max()) > 0 for _, g in tree_leaves(grads))
    assert all(not t.requires_grad for _, t in tree_leaves(pp))


@pytest.mark.parametrize("name", list(CASES))
def test_three_full_steps_match_reference(setups, name):
    """Three AdamW steps (cosine schedule, clip 1.0) from the same weights
    and batches: each step's loss, then every weight."""
    jcfg, jm, jp, pcfg, pm, pp = setups(name)
    jo = j_opt.adamw(lr=1e-3, schedule=j_opt.cosine_schedule(1, 3))
    po = optimizers.adamw(lr=1e-3, schedule=optimizers.cosine_schedule(1, 3))
    jstep = jax.jit(j_ts.make_full_train_step(jm, jcfg, jo))
    pstep = make_full_train_step(pm, pcfg, po)
    js, ps = jo.init(jp), po.init(pp)
    p0 = pp
    for i in range(3):
        b = _batch(jcfg, 10 + i)
        jp, js, jmet = jstep(jp, js, _jb(b))
        pp, ps, pmet = pstep(pp, ps, _tb(b))
        assert float(pmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    abs=LOSS_TOL)
    assert ps["count"] == 3
    _assert_steps_close(pp, jp, p0, 1e-3, 3)


def test_pretraining_steps_match_reference():
    """Ten full steps at the shape the reference's benchmark harness
    pretrains its base with (2 layers, d_model 128, vocab 300, 160-token
    rows of its mixed corpus, fp32, AdamW at lr 3e-3): every step's loss
    equals the reference's."""
    jcfg = tiny_dense(name="bench-llm", d_model=128, d_ff=256,
                      max_seq_len=160, lora_rank=8, dtype="float32",
                      param_dtype="float32")
    jm = get_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    pcfg = bridge.config_from_jax(jcfg)
    pm = Model(pcfg, device="cpu")
    pp = bridge.params_from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(0)
    tok = ByteTokenizer()
    texts = gen_pretrain_text(rng, 64) + [
        ex.prompt + ex.answer for ex in gen_log_dataset(rng, 64, 0)]
    seqs = [tok.encode(t, add_eos=True) for t in texts]
    jo, po = j_opt.adamw(lr=3e-3), optimizers.adamw(lr=3e-3)
    jstep = jax.jit(j_ts.make_full_train_step(jm, jcfg, jo))
    pstep = make_full_train_step(pm, pcfg, po)
    js, ps = jo.init(jp), po.init(pp)
    jl, pl = [], []
    for _ in range(10):
        idx = rng.integers(0, len(seqs), size=16)
        toks, mask = pad_batch([seqs[j] for j in idx], 160)
        b = {"tokens": toks, "loss_mask": mask}
        jp, js, jmet = jstep(jp, js, _jb(b))
        pp, ps, pmet = pstep(pp, ps, _tb(b))
        jl.append(float(jmet["loss"]))
        pl.append(float(pmet["loss"]))
    np.testing.assert_allclose(pl, jl, atol=LOSS_TOL, rtol=0)
    assert jl[-1] < jl[0]                  # the base learns


def test_full_step_walks_flash_attention_and_no_lora_kernel_on_meta():
    """llama2-7b at full width, 2 layers, 8 x 256 tokens, on the meta
    device under ``dryrun.measure``: one flash launch per layer, and one
    more in the forward that recomputation (the config's ``remat``) runs
    again in backward, and no other kernel; the arguments are the bf16 weights, the fp32 moments
    and the batch, exactly; at the peak the gradients, the new moments
    and the fp32 updates are live beside them."""
    cfg = get_config("llama2-7b").with_overrides(n_layers=2,
                                                  paged_backend="cuda")
    fn, args, model_flops = dryrun.build_full_train(
        Model(cfg, dryrun.META), cfg, 8, 256)
    res = dryrun.measure(fn, args, model_flops)
    assert cfg.remat
    assert {k: v["launches"] for k, v in res["kernels"].items()} == {
        "flash_attention": 2 * 2}
    assert not set(res["kernels"]) & (set(WRAPPERS) - {"flash_attention"})
    n = sum(t.numel() for t in dryrun.iter_tensors(args["params"]))
    mem = res["memory"]
    assert mem["argument_bytes_by"] == {
        "params": dryrun.storage_bytes(args["params"]), "opt_state": 8 * n,
        "inputs": 2 * 8 * 256 * 4}
    assert 2 * n < mem["argument_bytes_by"]["params"] < 2.001 * n
    assert mem["temp_bytes"] >= 14 * n
    # the new weights and moments, and the three fp32 scalar metrics
    assert mem["output_bytes"] == (mem["argument_bytes_by"]["params"]
                                   + mem["argument_bytes_by"]["opt_state"]
                                   + 3 * 4)
    assert res["roofline"]["model_flops"] == (6.0 * cfg.count_params()
                                              * 8 * 256)


def test_cuda_backend_refused_on_cpu_for_full_training(setups):
    jcfg, jm, jp, pcfg, pm, pp = setups("tiny_dense")
    with pytest.raises(ValueError, match="cuda"):
        make_full_train_step(pm, pcfg, optimizers.adamw(),
                             paged_backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        full_value_and_grad(pm, pcfg, "cuda")
