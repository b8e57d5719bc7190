"""The dual-LoRA state API and the serve CLI's ``--stream`` and
``--priority-mix`` through the port against the reference package on the
CPU.

``DualLoRAState`` and its ``replace``; ``check_same_rank``'s refusal with
the reference's message; ``fused_forward``'s logits against the
reference's on ``tiny_dense`` in fp32 (bridged weights, numpy-seeded
adapters with a non-zero B), and the unmerged dual tree it hands the
``"cuda"`` path giving the same forward on the plain path; the CLI's
stream lines against the events of ``generate_stream`` and its requests'
classes.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro.core import dual_lora as j_dual
from repro.core.lora import init_adapters as j_init_adapters
from repro.models.api import get_model
from repro_torch import bridge
from repro_torch.core import dual_lora
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.launch import serve
from repro_torch.models.api import Model
from repro_torch.serving.engine import MultiTenantEngine

LOGIT_TOL = 1e-4        # fp32 summation order on O(1) logits


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small torch ops under the suite's worker processes: one intra-op
    thread for this file (as tests/test_torch_ssm.py), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_dense(dtype="float32", param_dtype="float32")
    jm = get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pcfg = bridge.config_from_jax(jcfg)
    return (jcfg, jm, jp, pcfg, Model(pcfg, device="cpu"),
            bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu"))


def _adapters(jcfg, seed, rank=None):
    """A numpy-seeded reference adapter tree with a non-zero B."""
    tmpl = j_init_adapters(jax.random.PRNGKey(0), jcfg, rank=rank)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda l: (rng.standard_normal(l.shape) * 0.1).astype(np.float32),
        tmpl)


def test_dual_state_replace_as_the_reference(setup):
    jcfg, *_ = setup
    p, g = (bridge.adapters_from_jax(_adapters(jcfg, s), device="cpu")
            for s in (1, 2))
    w = torch.tensor([0.7, 0.4])
    st = dual_lora.DualLoRAState(p, g, w)
    new = st.replace(fusion_weights=torch.tensor([0.2, 0.9]))
    assert new is not st and new.personalized is p and new.global_ is g
    assert new.fusion_weights.tolist() == pytest.approx([0.2, 0.9])
    assert st.fusion_weights is w                 # the original is kept
    assert st.replace(global_=p).global_ is p
    # the reference's dataclass has the same fields, in the same order
    jst = j_dual.DualLoRAState({}, {}, jnp.asarray([0.7, 0.4]))
    assert ([f.name for f in dataclasses.fields(jst)]
            == [f.name for f in dataclasses.fields(st)])


def test_check_same_rank_refuses_with_the_reference_message(setup):
    jcfg, *_ = setup
    j4, j8 = _adapters(jcfg, 3), _adapters(jcfg, 4, rank=8)
    p4, p8 = (bridge.adapters_from_jax(t, device="cpu") for t in (j4, j8))
    with pytest.raises(ValueError) as want:
        j_dual.check_same_rank(j4, j8)
    with pytest.raises(ValueError) as got:
        dual_lora.check_same_rank(p4, p8)
    assert str(got.value) == str(want.value)
    assert "AdaFusion requires equal LoRA rank, got {4} vs {8}" in str(
        got.value)
    dual_lora.check_same_rank(p4, p4)              # equal ranks pass
    j_dual.check_same_rank(j4, j4)


def test_fused_forward_matches_reference(setup):
    jcfg, jm, jp, pcfg, pm, pp = setup
    ad_p, ad_s = _adapters(jcfg, 5), _adapters(jcfg, 6)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (3, 24)).astype(np.int32)
    w = np.asarray([0.7, 0.4], np.float32)
    jst = j_dual.DualLoRAState(jax.tree.map(jnp.asarray, ad_p),
                               jax.tree.map(jnp.asarray, ad_s),
                               jnp.asarray(w))
    jl, _ = j_dual.fused_forward(jm, jp, {"tokens": jnp.asarray(toks)}, jst,
                                 2.0)
    tp, ts = (bridge.adapters_from_jax(t, device="cpu")
              for t in (ad_p, ad_s))
    st = dual_lora.DualLoRAState(tp, ts, torch.from_numpy(w))
    batch = {"tokens": torch.from_numpy(toks)}
    logits, aux = dual_lora.fused_forward(pm, pp, batch, st, 2.0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               atol=LOGIT_TOL, rtol=1e-4)
    assert float(aux) == 0.0
    # the dual tree the "cuda" path takes gives the merged forward here
    ld, _ = pm.forward(pp, batch, dual_lora.dual_tree(tp, ts, w), 2.0)
    torch.testing.assert_close(ld, logits, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="cuda"):
        dual_lora.fused_forward(pm, pp, batch, st, 2.0, paged_backend="cuda")


STREAM_LINE = re.compile(
    r"^  \[stream\] req(\d+) \+(\d+) \((\d+) total\)( <done>)?: (.*)$")


def test_serve_cli_stream_and_priority_mix(monkeypatch, capsys):
    """``--stream`` prints one line per ``generate_stream`` event (the
    reference CLI's line) whose increments concatenate, request by
    request, to the tokens of the same run without it; ``--priority-mix
    interactive,batch`` puts request i in ``mix[i % 2]``; no mix puts
    every request in ``batch``; an unknown class is refused."""
    runs = []
    original = MultiTenantEngine.generate_stream

    def recording(self, requests, sc):
        run = {"classes": [r.priority for r in requests], "events": []}
        runs.append(run)
        for event in original(self, requests, sc):
            run["events"].append(event)
            yield event

    monkeypatch.setattr(MultiTenantEngine, "generate_stream", recording)
    args = ["--smoke", "--device", "cpu", "--tenants", "2", "--batch", "2",
            "--requests", "4", "--new-tokens", "6", "--priority-mix",
            "interactive,batch"]
    serve.main(args + ["--stream"])
    streamed = capsys.readouterr().out
    serve.main(args)
    plain = capsys.readouterr().out
    assert "[stream]" not in plain
    mix = ["interactive", "batch"]
    assert [r["classes"] for r in runs] == [[mix[i % 2] for i in range(4)]] * 2

    lines = [STREAM_LINE.match(ln) for ln in streamed.splitlines()
             if "[stream]" in ln]
    events = runs[0]["events"]
    assert len(lines) == len(events) and all(lines)
    tok, totals = ByteTokenizer(), [0] * 4
    for m, (rid, toks, finished) in zip(lines, events):
        totals[rid] += len(toks)
        assert (int(m[1]), int(m[2]), int(m[3]), bool(m[4])) == (
            rid, len(toks), totals[rid], finished)
        assert m[5] == repr(tok.decode(np.asarray(toks))[:24])

    def by_request(evs):
        out = [[] for _ in range(4)]
        for rid, toks, _ in evs:
            out[rid].extend(toks)
        return out
    assert by_request(events) == by_request(runs[1]["events"])
    assert all(0 < len(t) <= 6 for t in by_request(events))
    # one <done> per request, on its last line
    assert sum(bool(m[4]) for m in lines) == 4

    assert all(r.priority == "batch"
               for r in serve.ragged_requests(4, 2, 512, 8, 32))
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--priority-mix",
                    "interactive,urgent"])
    assert "unknown classes ['urgent']" in capsys.readouterr().err
