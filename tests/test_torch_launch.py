"""The port's full-size tooling against the reference package on the CPU:
the arch × shape registry (``configs/registry.py``), the input stand-ins
(``launch/specs.py``) and the roofline's counts and ring factors
(``analysis/roofline.py``).

Registry lists, ``INPUT_SHAPES`` and the shape-support matrix equal;
``config_for_shape`` field by field for every arch × shape, smoke and
full; ``train_inputs`` / ``decode_inputs`` with the reference's keys,
shapes and dtypes for every arch × shape; ``model_flops_*`` equal for
every arch; ``ring_bytes`` equal to the reference's ``parse_collectives``
on HLO lines built here for each of the five collectives.
"""
import dataclasses

import pytest
import torch

from repro.analysis import roofline as j_rl
from repro.configs import base as j_base
from repro.configs import registry as j_reg
from repro.launch import specs as j_specs
from repro_torch import bridge
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ALL_ARCHS as PORT_ARCHS
from repro_torch.configs import base, registry
from repro_torch.launch import specs

ARCH_SHAPES = [(a, s) for a in j_reg.ALL_ARCHS for s in j_base.INPUT_SHAPES]


def test_registry_lists_and_shapes_equal_the_reference():
    assert registry.ALL_ARCHS == j_reg.ALL_ARCHS
    assert registry.ASSIGNED_ARCHS == j_reg.ASSIGNED_ARCHS
    assert sorted(PORT_ARCHS) == sorted(registry.ALL_ARCHS)
    assert list(base.INPUT_SHAPES) == list(j_base.INPUT_SHAPES)
    for name, sh in j_base.INPUT_SHAPES.items():
        assert dataclasses.astuple(base.INPUT_SHAPES[name]) \
            == dataclasses.astuple(sh)
        assert registry.get_shape(name) == base.INPUT_SHAPES[name]


def test_shape_support_matrix_equals_the_reference():
    got = {(a, s): registry.shape_supported(a, s) for a, s in ARCH_SHAPES}
    want = {(a, s): j_reg.shape_supported(a, s) for a, s in ARCH_SHAPES}
    assert got == want
    assert [k for k, v in got.items() if not v] == [("whisper-small",
                                                     "long_500k")]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch,shape", ARCH_SHAPES)
def test_config_for_shape_field_by_field(arch, shape, smoke):
    want = bridge.config_from_jax(j_reg.config_for_shape(arch, shape, smoke))
    if arch == "llama2-7b" and smoke and want.max_seq_len == 64:
        # the port's llama2-smoke keeps 160 positions where the reference's
        # has 64 (configs/llama2_7b.py says why); the long shapes raise both
        want = want.with_overrides(max_seq_len=160)
    got = registry.config_for_shape(arch, shape, smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_for_shape_windows_and_lengths():
    """The two adjustments, as the reference makes them."""
    cfg = registry.config_for_shape("yi-6b", "long_500k")
    assert cfg.sliding_window == 4096 and cfg.max_seq_len == 524288
    assert registry.config_for_shape("mamba2-2.7b", "long_500k"
                                     ).sliding_window == 0
    assert registry.config_for_shape("yi-6b", "train_4k") \
        == registry.get_config("yi-6b")


def _spec(t):
    """(shape, dtype name) of a reference ShapeDtypeStruct or a tensor."""
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), str(t.dtype).split(".")[-1]
    return tuple(t.shape), str(t.dtype)


@pytest.mark.parametrize("arch,shape", ARCH_SHAPES)
def test_inputs_equal_the_reference(arch, shape):
    jcfg = j_reg.config_for_shape(arch, shape)
    cfg = registry.config_for_shape(arch, shape)
    for fn, j_fn in ((specs.train_inputs, j_specs.train_inputs),
                     (specs.decode_inputs, j_specs.decode_inputs)):
        got, want = fn(cfg, shape), j_fn(jcfg, shape)
        assert list(got) == list(want)
        assert {k: _spec(v) for k, v in got.items()} \
            == {k: _spec(v) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())


@pytest.mark.parametrize("arch", j_reg.ALL_ARCHS)
def test_model_flops_equal_the_reference(arch):
    jcfg, cfg = j_reg.get_config(arch), registry.get_config(arch)
    for tokens in (1, 4096 * 256):
        assert rl.model_flops_train(cfg, tokens) \
            == j_rl.model_flops_train(jcfg, tokens)
        assert rl.model_flops_decode(cfg, tokens) \
            == j_rl.model_flops_decode(jcfg, tokens)


@pytest.mark.parametrize("op", rl.RING_OPS)
@pytest.mark.parametrize("group", [1, 4, 16])
def test_ring_bytes_match_the_reference_parser(op, group):
    """One HLO line per collective, in the reference's replica-group
    syntax; its parsed per-chip bytes against :func:`ring_bytes`."""
    groups = "{" + ",".join(str(i) for i in range(group)) + "}"
    line = (f"  %x.1 = bf16[8,1024,512]{{2,1,0}} {op}(bf16[8,1024,512] %y), "
            f"replica_groups={{{groups}}}")
    (c,) = j_rl.parse_collectives(line)
    assert c.op == op and c.group_size == group
    assert rl.ring_bytes(op, c.out_bytes, group) == c.per_chip_bytes


def test_ring_bytes_refuses_an_unknown_op():
    with pytest.raises(ValueError, match="unknown collective"):
        rl.ring_bytes("all-sum", 8, 2)


def test_analyze_terms_and_the_one_card_rule():
    r = rl.analyze(989e12, 3.35e12, 1, model_flops=494.5e12)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == 0.0 and r.useful_ratio == pytest.approx(0.5)
    assert rl.analyze(1e9, 1e12).dominant == "memory"
    assert rl.analyze(1e15, 1e9).dominant == "compute"
    assert set(r.to_dict()) == {f.name for f in
                                dataclasses.fields(j_rl.Roofline)}
    # one card: no link, so no collective term; more cards read the
    # round's collective log over the data sheet's link rate
    assert rl.analyze(1.0, 1.0, chips=4).collective_s == 0.0
    log = [rl.Collective("all-reduce", "pod", 4, 800,
                         rl.ring_bytes("all-reduce", 800, 4))]
    assert rl.analyze(1.0, 1.0, chips=4, collectives=log).collective_s == \
        pytest.approx(1200 / rl.NVLINK_BW)
    with pytest.raises(ValueError, match="chips"):
        rl.analyze(1.0, 1.0, chips=0)
