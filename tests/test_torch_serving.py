"""The port's ``MultiTenantEngine`` against the reference engine (CPU).

Same weights and adapters (bridged from numpy, non-zero B), same requests:
greedy token streams must be EQUAL, token for token — the two packages
plan the same chunks (the port keeps its own copy of the scheduler) and
compute the same fp32 logits up to summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.core.lora import init_adapters as j_init_adapters
from repro.models.api import get_model
from repro.serving.engine import MultiTenantEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.registry import AdapterRegistry as JRegistry
from repro_torch import bridge
from repro_torch.models.api import Model
from repro_torch.serving.engine import MultiTenantEngine, Request, ServeConfig
from repro_torch.serving.registry import AdapterRegistry

TENANTS = 3


@pytest.fixture(scope="module")
def engines():
    jcfg = tiny_dense(dtype="float32", param_dtype="float32")
    pcfg = bridge.config_from_jax(jcfg)
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jreg = JRegistry(jcfg, capacity=4)
    reg = AdapterRegistry(pcfg, capacity=4, device="cpu")
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg)
    for i in range(TENANTS):
        rng = np.random.default_rng(100 + i)
        tree = jax.tree.map(lambda l: (rng.standard_normal(l.shape) * 0.1)
                            .astype(np.float32), tmpl)
        jreg.register(f"c{i}", jax.tree.map(jnp.asarray, tree))
        reg.register(f"c{i}", bridge.adapters_from_jax(tree, device="cpu"))
    jeng = JEngine(jm, jcfg, jp, jreg)
    peng = MultiTenantEngine(Model(pcfg, device="cpu"), pcfg,
                             bridge.params_from_jax(jax.tree.map(np.asarray,
                                                                 jp), device="cpu"), reg)
    return jcfg, jeng, peng


def _requests(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"c{i % TENANTS}",
             rng.integers(0, vocab, int(rng.integers(5, 23))).astype(np.int32),
             int(rng.integers(3, 9))) for i in range(n)]


def _both(engines, reqs, **kw):
    jcfg, jeng, peng = engines
    jout = jeng.generate([JRequest(c, p, max_new_tokens=b)
                          for c, p, b in reqs],
                         JServeConfig(overlap=False, **kw))
    pout = peng.generate([Request(c, p, max_new_tokens=b)
                          for c, p, b in reqs], ServeConfig(**kw))
    return jout, pout, jeng.last_stats, peng.last_stats


def test_greedy_streams_equal_reference_with_preemption(engines):
    """Ragged prompts longer than the prefill chunk, more requests than
    slots, and a pool small enough that both engines preempt."""
    jcfg = engines[0]
    reqs = _requests(jcfg.vocab_size, 6)
    jout, pout, jst, pst = _both(engines, reqs, batch_size=3,
                                 max_new_tokens=8, block_size=4,
                                 num_blocks=12, prefill_chunk=6)
    assert jst["preemptions"] > 0 and pst["preemptions"] > 0
    assert pst["preemptions"] == jst["preemptions"]
    assert pst["prefill_dispatches"] == jst["prefill_dispatches"]
    assert pst["decode_dispatches"] == jst["decode_dispatches"]
    for (_, _, budget), a, b in zip(reqs, jout, pout):
        assert len(b) == budget
        np.testing.assert_array_equal(b, a)


def test_greedy_streams_equal_reference_full_residency_fcfs(engines):
    jcfg = engines[0]
    reqs = _requests(jcfg.vocab_size, 5, seed=1)
    jout, pout, jst, pst = _both(engines, reqs, batch_size=2,
                                 max_new_tokens=8, block_size=4,
                                 prefill_chunk=4, sched_policy="fcfs",
                                 eos_id=int(reqs[0][1][0]))
    for a, b in zip(jout, pout):
        np.testing.assert_array_equal(b, a)


def test_stream_events_and_stats(engines):
    _, _, peng = engines
    reqs = [Request("c0", np.arange(1, 12, dtype=np.int32), 4),
            Request("c2", np.arange(3, 8, dtype=np.int32), 2)]
    sc = ServeConfig(batch_size=2, prefill_chunk=4, block_size=4)
    seen = {0: [], 1: []}
    done = set()
    for rid, toks, fin in peng.generate_stream(reqs, sc):
        assert rid not in done
        seen[rid].extend(toks)
        if fin:
            done.add(rid)
    assert done == {0, 1} and [len(seen[0]), len(seen[1])] == [4, 2]
    st = peng.last_stats
    assert st["prompt_tokens"] == 16 and st["preemptions"] == 0


def test_temperature_sampling_replays_from_the_seed(engines):
    _, _, peng = engines
    reqs = [Request(f"c{i}", np.arange(2 + i, 9 + i, dtype=np.int32))
            for i in range(3)]
    sc = ServeConfig(batch_size=3, max_new_tokens=6, temperature=0.8,
                     seed=5, block_size=4, prefill_chunk=4)
    a = peng.generate(reqs, sc)
    b = peng.generate(reqs, sc)
    c = peng.generate(reqs, dataclasses.replace(sc, seed=6))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any((x != y).any() for x, y in zip(a, c))


def test_open_loop_session(engines):
    _, _, peng = engines
    with pytest.raises(ValueError, match="num_blocks"):
        peng.session(ServeConfig(batch_size=2))
    ses = peng.session(ServeConfig(batch_size=2, num_blocks=12,
                                   block_size=4, max_new_tokens=3))
    assert ses.step() == []                            # idle
    ses.submit(Request("c1", np.arange(5, dtype=np.int32)))
    out = []
    while ses.has_work:
        out += [t for _, toks, _ in ses.step() for t in toks]
    assert len(out) == 3
    assert ses.finalize()["open_loop"] is True


def test_cuda_backend_is_refused_on_the_cpu(engines):
    _, _, peng = engines
    reqs = [Request("c0", np.arange(6, dtype=np.int32))]
    with pytest.raises(ValueError, match="CPU allows only 'torch'"):
        peng.generate(reqs, ServeConfig(batch_size=1, paged_backend="cuda"))


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--smoke", "--device", "cpu", "--tenants", "2", "--batch", "2",
          "--requests", "3", "--new-tokens", "3", "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert "2 tenants, 3 ragged requests over 2 slots on cpu" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            main(["--smoke", "--tenants", "1", "--batch", "1"])
