"""The port stands alone: nothing in ``src/repro_torch`` or ``chip_smoke.py``
imports JAX or the reference package (an AST scan, so a module that is
never imported by the tests is covered too)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "triton")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


# the modules of each slice of the port; every one is scanned below
SLICE_MODULES = [
    # serving
    "bridge.py", "configs/base.py", "core/lora.py", "core/dual_lora.py",
    "kernels/batched_lora.py", "kernels/paged_attention.py",
    "kernels/paged_prefill.py", "kernels/ops.py", "kernels/ref.py",
    "models/layers.py", "models/model.py", "models/api.py",
    "serving/engine.py", "serving/registry.py", "launch/serve.py",
    # training
    "kernels/lora_matmul.py", "kernels/dual_lora.py",
    "kernels/flash_attention.py", "core/outer_opt.py", "core/fusion.py",
    "core/fdlora.py", "training/optimizers.py", "training/train_step.py",
    "training/checkpoint.py", "data/tokenizer.py", "data/synthetic.py",
    "data/pipeline.py", "data/partition.py", "launch/train.py",
    # serving options and the last kernel
    "kernels/quant.py", "kernels/build.py", "kernels/__init__.py",
    "serving/kv_cache.py", "serving/scheduler.py", "serving/spec_decode.py",
    # overlapped dispatch and the open-loop drivers
    "serving/trace.py",
    # the rest of the dense family
    "configs/__init__.py", "configs/llama2_7b.py", "configs/gemma_2b.py",
    "configs/olmo_1b.py", "configs/yi_6b.py", "configs/starcoder2_15b.py",
    # sharded serving and the fixed path
    "serving/sharded.py",
    # the federated baselines and the client-stacked round step
    "federated/__init__.py", "federated/baselines.py",
    "federated/distributed.py",
    # the MoE family
    "models/moe.py", "configs/dbrx_132b.py", "configs/kimi_k2_1t_a32b.py",
]


def test_the_port_has_files():
    assert len(FILES) > 20


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_is_scanned(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imported(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
