"""The port's mesh and spec trees against the reference's, on the CPU.

Every ``*_specs`` tree of the port (params, decode caches, paged caches
at f32 and int8 K/V, adapters, client-stacked adapters, batches) equals
the reference's for every arch of the registry, full and smoke, once the
reference's period-stacked blocks are laid out per layer as
``repro_torch.bridge`` lays out the weights (a stacked leaf's spec loses
its period entry).  ``batch_axes`` and the input specs agree at (1, 1),
(16, 16) and (2, 16, 16): the reference gets a stand-in with
``axis_names`` and ``devices.shape``, the port a dict, which is all either
reads.  Then ``sharding_tree`` / ``pad_spec_to`` on dividing and
non-dividing shapes, ``local_shard`` on a stand-in rank, the mesh
factories (mirrors of ``tests/test_launch.py``) and the roofline's
collective term (mirrors of ``tests/test_distributed.py``).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import roofline as j_rl
from repro.configs.registry import ALL_ARCHS
from repro.configs.registry import get_config as j_get_config
from repro.core.lora import adapter_specs as j_adapter_specs
from repro.federated import distributed as j_dist
from repro.launch import specs as j_sp
from repro.models.api import get_model as j_get_model
from repro_torch.analysis import roofline as rl
from repro_torch.configs import get_config
from repro_torch.core.lora import adapter_specs
from repro_torch.core.partition import P, mesh_coordinate, mesh_shape
from repro_torch.federated import distributed
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as sp
from repro_torch.models.api import Model

SHAPES = [{"data": 1, "model": 1}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file (as tests/test_torch_ssm.py);
    a process group this file starts is stopped after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    running = dist.is_initialized()
    yield
    torch.set_num_threads(n)
    if not running and dist.is_initialized():
        dist.destroy_process_group()


def plain(tree):
    """Spec trees of either package as nested dicts/lists of tuples."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [plain(v) for v in tree]
    return tuple(tree)


def per_layer(tree, n_layers):
    """The reference's ``{"b<j>": stacked}`` spec tree -> the port's list
    of layers (layer i is period i // period of block i % period), each
    spec without its leading period entry."""
    period = len(tree)

    def drop(t):
        if isinstance(t, dict):
            return {k: drop(v) for k, v in t.items()}
        return tuple(t)[1:]
    return [drop(tree[f"b{i % period}"]) for i in range(n_layers)]


def ref_layout(tree, cfg):
    """A reference spec tree (params, caches or adapters) in the port's
    layout: its ``blocks`` become ``layers``; the encoder-decoder keeps
    its stacked layout, its ring buffers' write count one int."""
    out = plain(tree)
    if cfg.is_encdec:
        if "self" in out:
            out["self"]["pos"] = ()
        return out
    out["layers"] = per_layer(tree["blocks"], cfg.n_layers)
    del out["blocks"]
    return out


def _configs():
    return [(a, s) for a in ALL_ARCHS for s in (False, True)]


@pytest.mark.parametrize("arch,smoke", _configs(),
                         ids=[f"{a}{'-smoke' if s else ''}"
                              for a, s in _configs()])
def test_spec_trees_match_reference(arch, smoke):
    jcfg = j_get_config(arch, smoke=smoke)
    cfg = get_config(arch, smoke=smoke)
    jm, m = j_get_model(jcfg), Model(cfg, device="cpu")
    assert plain(m.param_specs()) == ref_layout(jm.param_specs(), cfg)
    assert plain(m.decode_cache_specs()) == ref_layout(
        jm.decode_cache_specs(), cfg)
    ref_ad = ref_layout(j_adapter_specs(jcfg), cfg)
    assert plain(adapter_specs(cfg)) == ref_ad
    if cfg.is_encdec:
        assert plain(distributed.client_stacked_specs(adapter_specs(cfg))) \
            == plain(j_dist.client_stacked_specs(j_adapter_specs(jcfg)))
        with pytest.raises(NotImplementedError):
            m.paged_decode_cache_specs()
        return
    for kv in ("f32", "int8"):
        assert plain(m.paged_decode_cache_specs(kv)) == ref_layout(
            jm.paged_decode_cache_specs(kv), cfg)
    # client-stacked adapters: the client axis on "pod" before each spec
    stacked = plain(distributed.client_stacked_specs(adapter_specs(cfg)))
    want = [{part: {t: {k: ("pod",) + s for k, s in ab.items()}
                    for t, ab in targets.items()}
             for part, targets in layer.items()}
            for layer in ref_ad["layers"]]
    assert stacked["layers"] == want


def test_client_stacked_and_batch_specs():
    spec = {"x": [{"a": P(None, "model")}]}
    assert plain(distributed.client_stacked_specs(spec)) == {
        "x": [{"a": ("pod", None, "model")}]}
    assert tuple(distributed.batch_specs()) == tuple(j_dist.batch_specs())
    assert tuple(distributed.batch_specs("train")) == (
        "pod", None, "data", None)


def _stand_in(shape):
    """What the reference's spec functions read of a jax mesh."""
    return types.SimpleNamespace(
        axis_names=tuple(shape),
        devices=types.SimpleNamespace(shape=tuple(shape.values())))


@pytest.mark.parametrize("shape", SHAPES, ids=["1x1", "16x16", "2x16x16"])
def test_batch_axes_and_input_specs_match_reference(shape):
    ref = _stand_in(shape)
    for B in (1, 2, 16, 32, 64, 128, 256, 512):
        assert sp.batch_axes(shape, B) == j_sp.batch_axes(ref, B)
    for arch in ("llama2-7b", "internvl2-26b", "whisper-small"):
        jcfg, cfg = j_get_config(arch), get_config(arch)
        for name in ("train_4k", "prefill_32k", "long_500k"):
            if name == "long_500k" and arch == "whisper-small":
                continue
            assert plain(sp.train_input_specs(cfg, shape, name)) == plain(
                j_sp.train_input_specs(jcfg, ref, name))
        for name in ("decode_32k", "long_500k"):
            assert plain(sp.decode_input_specs(cfg, shape, name)) == plain(
                j_sp.decode_input_specs(jcfg, ref, name))


def test_sharding_tree_drops_missing_axes_as_the_reference():
    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from jax.sharding import PartitionSpec as JP
    jmesh = j_host_mesh()                       # (1, 1) on the CPU
    ref = j_sp.sharding_tree(jmesh, {
        "a": JP(("pod", "data"), None), "b": [JP("pod", "model")],
        "c": JP()})
    got = sp.sharding_tree({"data": 1, "model": 1}, {
        "a": P(("pod", "data"), None), "b": [P("pod", "model")], "c": P()})
    assert plain(got) == {"a": tuple(ref["a"].spec),
                          "b": [tuple(ref["b"][0].spec)],
                          "c": tuple(ref["c"].spec)}


def test_sharding_tree_replicates_where_an_axis_does_not_divide():
    mesh = {"pod": 2, "data": 4, "model": 1}
    specs = {"x": P("pod", None, "data", None),
             "y": P(("pod", "data"), "model"), "z": P("data")}
    leaves = {"x": torch.empty(2, 3, 8, 5), "y": torch.empty(6, 4),
              "z": torch.empty(3)}
    got = sp.sharding_tree(mesh, specs, leaves)
    assert plain(got) == {"x": ("pod", None, "data", None),
                          "y": (None, "model"), "z": (None,)}
    leaves["y"] = torch.empty(16, 4)
    assert tuple(sp.sharding_tree(mesh, specs, leaves)["y"]) == (
        ("pod", "data"), "model")


def test_pad_spec_to_matches_reference():
    import jax
    from jax.sharding import PartitionSpec as JP
    specs = {"a": P("data"), "b": P(None, "model", None), "c": P()}
    jspecs = {"a": JP("data"), "b": JP(None, "model", None), "c": JP()}
    shapes = {"a": torch.empty(4, 3, 2), "b": torch.empty(4, 3),
              "c": torch.empty(2)}
    jshapes = {k: jax.ShapeDtypeStruct(tuple(v.shape), "float32")
               for k, v in shapes.items()}
    assert plain(sp.pad_spec_to(specs, shapes)) == plain(
        j_sp.pad_spec_to(jspecs, jshapes))


def test_abstract_tree_runs_on_the_meta_device():
    out = sp.abstract_tree(lambda: {"w": torch.zeros(3, 4),
                                    "b": [torch.ones(2)]})
    assert out["w"].device.type == "meta" and out["w"].shape == (3, 4)
    assert out["b"][0].shape == (2,)


class FakeRank:
    """A rank of a mesh as ``local_shard`` reads it: axis names, sizes and
    this rank's coordinate."""

    def __init__(self, shape, coord):
        self.mesh_dim_names = tuple(shape)
        self._sizes, self._coord = list(shape.values()), tuple(coord)

    def size(self, i):
        return self._sizes[i]

    def get_coordinate(self):
        return self._coord


def test_local_shard_takes_the_rank_rows():
    shape = {"pod": 2, "data": 2, "model": 1}
    x = torch.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5)
    count = np.array([3, 7])
    tree = {"b": x, "count": count, "v": torch.ones(6), "n": 4}
    specs = {"b": distributed.batch_specs(), "count": P("pod"), "v": P(),
             "n": P()}
    for p in range(2):
        for d in range(2):
            got = distributed.local_shard(tree, specs, FakeRank(shape, (p, d, 0)))
            assert torch.equal(got["b"], x[p:p + 1, :, 2 * d:2 * d + 2])
            assert list(got["count"]) == [count[p]]
            assert torch.equal(got["v"], tree["v"]) and got["n"] == 4
    flat = distributed.local_shard({"y": torch.arange(8)},
                                   {"y": P(("pod", "data"))},
                                   FakeRank(shape, (1, 0, 0)))
    assert flat["y"].tolist() == [4, 5]         # pod major
    with pytest.raises(ValueError, match="does not divide"):
        distributed.local_shard({"b": torch.zeros(2, 1, 3, 1)},
                                {"b": distributed.batch_specs()},
                                FakeRank(shape, (0, 0, 0)))


def test_state_specs_shard_the_step_count_with_the_clients():
    tree = {"layers": [{"mixer": {"wq": {"a": torch.zeros(4, 2),
                                         "b": torch.zeros(2, 4)}}}]}
    ad = {"layers": [{"mixer": {"wq": {"a": P(None, None),
                                       "b": P(None, "model")}}}]}
    state = {"inner_opt": {"mu": tree, "nu": tree, "count": np.zeros(2)},
             "outer_opt": {"v": tree}, "personalized": tree}
    s = plain(distributed.state_specs(ad, state))
    assert s["inner_opt"]["count"] == ("pod",)
    assert s["inner_opt"]["mu"]["layers"][0]["mixer"]["wq"]["b"] == (
        "pod", None, "model")
    assert s["personalized"] == s["inner_opt"]["nu"]
    assert s["outer_opt"]["v"]["layers"][0]["mixer"]["wq"]["a"] == ()


# ---------------------------------------------------------------------------
# mesh factories (mirrors of tests/test_launch.py) and the P spec itself
# ---------------------------------------------------------------------------

def test_host_mesh_default_shape():
    mesh = mesh_lib.make_host_mesh(device="cpu")
    n = dist.get_world_size()
    assert mesh.mesh_dim_names == ("data", "model")
    assert mesh_shape(mesh) == {"data": n, "model": 1}
    assert mesh_coordinate(mesh) == {"data": 0, "model": 0}
    assert sp.batch_axes(mesh, 256) == ("data",)


def test_host_mesh_model_axis_must_divide_devices():
    mesh_lib.make_host_mesh(device="cpu")
    n = dist.get_world_size()
    with pytest.raises(ValueError, match="not divisible by the model axis"):
        mesh_lib.make_host_mesh(model=n + 1, device="cpu")


def test_host_mesh_rejects_nonpositive_model_axis():
    with pytest.raises(ValueError, match="must be >= 1"):
        mesh_lib.make_host_mesh(model=0, device="cpu")


def test_production_mesh_needs_real_pod():
    with pytest.raises(ValueError, match="use make_host_mesh"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 devices"):
        mesh_lib.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        mesh_lib.make_mesh(pod=2, data=1, device="cpu")


def test_mesh_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    with pytest.raises(RuntimeError, match="cuda"):
        mesh_lib.make_host_mesh()


def test_partition_spec_canonicalises_as_jax():
    from jax.sharding import PartitionSpec as JP
    for entries in [(("data",), None), (("pod", "data"), None), (None,), (),
                    ("model", None, None)]:
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert P("data") == P(("data",)) and P("data") != P("model")
    assert repr(P(None, "model")) == "P(None, 'model')"


# ---------------------------------------------------------------------------
# the roofline's collective term (mirrors of tests/test_distributed.py)
# ---------------------------------------------------------------------------

def test_roofline_terms_and_dominance():
    r = rl.analyze(rl.PEAK_FLOPS, rl.HBM_BW * 2, chips=4,
                   model_flops=rl.PEAK_FLOPS * 4)
    assert abs(r.compute_s - 1.0) < 1e-6
    assert abs(r.memory_s - 2.0) < 1e-6
    assert r.dominant == "memory" and abs(r.useful_ratio - 1.0) < 1e-6
    assert r.collective_s == 0.0 and r.n_collectives == 0


def test_collective_factors_and_the_logged_all_reduce():
    hlo = """
  %ar = bf16[1024]{0} all-reduce(%a), replica_groups={{0,1,2,3}}
  %ag = bf16[1024]{0} all-gather(%b), replica_groups=[2,4]
  %rs = bf16[256]{0} reduce-scatter(%c), replica_groups={{0,1,2,3}}
"""
    for c in j_rl.parse_collectives(hlo):
        assert rl.ring_bytes(c.op, c.out_bytes, c.group_size) == \
            c.per_chip_bytes
    mesh = mesh_lib.make_host_mesh(device="cpu")
    mesh_lib.reset_collectives()
    t = torch.ones(1024, dtype=torch.bfloat16)
    mesh_lib.all_reduce(t, mesh, "data")
    (c,) = mesh_lib.collectives()
    n = dist.get_world_size()
    assert (c.op, c.axis, c.group, c.bytes) == ("all-reduce", "data", n, 2048)
    assert c.per_card_bytes == rl.ring_bytes("all-reduce", 2048, n)
    assert torch.equal(t, torch.full((1024,), float(n),
                                     dtype=torch.bfloat16))
    # four cards: NVLink 4 at 450 GB/s; 16 leave the node: NDR at 50 GB/s
    four = rl.Collective("all-reduce", "pod", 4, 2048,
                         rl.ring_bytes("all-reduce", 2048, 4))
    assert four.per_card_bytes == 2 * 2048 * 3 / 4
    r = rl.analyze(1.0, 1.0, chips=4, collectives=[four, four])
    assert r.collective_bytes == 2 * four.per_card_bytes
    assert r.collective_s == pytest.approx(2 * 3072 / 450e9)
    assert r.n_collectives == 2 and r.coll_by_op == {"all-reduce": 6144.0}
    assert rl.analyze(1.0, 1.0, chips=16, collectives=[four]
                      ).collective_s == pytest.approx(3072 / 50e9)
    assert set(dataclasses.asdict(r)) == {
        f.name for f in dataclasses.fields(j_rl.Roofline)}
