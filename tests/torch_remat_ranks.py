"""Rank program of ``tests/test_torch_remat.py`` (importable by the ranks
``launch/mesh.spawn`` starts; no JAX here, so a rank starts quickly).

:func:`model2_steps` runs on each of two ranks of a ``(1, 1, 2)`` mesh:
for each recomputation setting, the LoRA gradient of this rank's shards
(the replicated leaves summed over the model group) and the collectives
of one SGD train step."""
import dataclasses

from repro_torch.core.lora import adapter_specs
from repro_torch.federated.distributed import local_shard
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.api import Model
from repro_torch.models.model import param_specs
from repro_torch.training.optimizers import sgd
from repro_torch.training.train_step import (make_lora_loss_fn,
                                             make_lora_train_step,
                                             model_group_grads,
                                             value_and_grad)


def model2_steps(cfgs, params, adapters, batch):
    """``cfgs``: setting name -> config.  Returns this rank's model
    coordinate and, per setting, its loss, gradient shards and the train
    step's collective log."""
    mesh = mesh_lib.make_mesh(1, 1, 2, device="cpu")
    tp = mesh_lib.model_group(mesh)
    out = {"model": mesh_lib.mesh_coordinate(mesh)["model"]}
    for name, cfg in cfgs.items():
        model = Model(cfg, "cpu")
        specs = adapter_specs(cfg)
        pl = local_shard(params, param_specs(cfg), mesh)
        al = local_shard(adapters, specs, mesh)
        vg = value_and_grad(make_lora_loss_fn(model, cfg, tp=tp))
        loss, _, grads = vg(al, pl, batch)
        (grads,), _ = model_group_grads([grads], tpl.replicated(specs), tp)
        opt = sgd(0.1)
        step = make_lora_train_step(model, cfg, opt, tp=tp)
        mesh_lib.reset_collectives()
        step(pl, al, opt.init(al), batch)
        out[name] = {"loss": loss, "grads": grads,
                     "collectives": [dataclasses.asdict(c)
                                     for c in mesh_lib.collectives()]}
    return out
