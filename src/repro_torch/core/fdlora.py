"""FDLoRA Algorithm 1, the paper's training procedure, end to end.

Port of ``repro/core/fdlora.py``:

Stage 1  Local learning: every client SFTs its personalized LoRA on local
         data (Eq. 5); the global LoRA starts at the client mean (Eq. 6).
Stage 2  Federated learning: T outer rounds; each round every client pulls
         θ_s, runs K inner AdamW steps on it (line 12), re-syncs its
         personalized LoRA every H rounds (lines 13-15); the server
         Nesterov-updates θ_s from the mean pseudo-gradient (lines 17-18).
Stage 3  AdaFusion: per client, a gradient-free search for the fusion
         weights (Eq. 7/8) on a few-shot set Q.

Clients run one after another on one device.  The trainer runs on the
card unless the caller asks for the CPU; ``paged_backend`` picks the
kernels (``None``: ``"cuda"`` on a card, where every projection of a
train step runs the LoRA kernel, every attention the flash-attention
kernel and every projection of a stage-3 evaluation the dual-LoRA kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fusion as fusion_lib
from repro_torch.core.dual_lora import merge
from repro_torch.core.lora import (init_adapters, lora_scale, tree_leaves,
                                   tree_mean)
from repro_torch.core.outer_opt import make_outer_optimizer, outer_step
from repro_torch.models.model import resolve_backend
from repro_torch.training.optimizers import adamw
from repro_torch.training.train_step import (make_fused_eval_fn,
                                             make_lora_train_step)

Params = Any


@dataclasses.dataclass
class FDLoRAConfig:
    n_clients: int = 5
    rounds: int = 30                 # T
    inner_steps: int = 3             # K
    sync_every: int = 10             # H (0 => never, i.e. H = ∞)
    batch_size: int = 8
    stage1_steps: int = 30           # SFT batches for stage 1
    inner_lr: float = 2e-4
    inner_weight_decay: float = 0.01
    outer_kind: str = "nesterov"     # nesterov | sgd | fedavg
    outer_lr: float = 1e-3
    outer_momentum: float = 0.5
    fusion_method: str = "es"
    fusion_steps: int = 5            # paper: max 5 optimization steps
    fusion_l1: float = 0.05          # λ
    few_shot_k: int = 16             # |Q|
    seed: int = 0


@dataclasses.dataclass
class ClientState:
    personalized: Params
    global_copy: Params              # θ_s^(i), this round's working copy
    inner_opt_state: Any
    fusion_weights: np.ndarray
    comm_bytes_up: float = 0.0
    comm_bytes_down: float = 0.0


def tree_bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size()
                     for _, t in tree_leaves(tree)))


class FDLoRATrainer:
    """Runs Algorithm 1 against a frozen base model and per-client
    batchers (objects with ``sample()`` and ``few_shot(k)`` returning numpy
    batches, as ``data.pipeline.SFTBatcher``)."""

    def __init__(self, model, cfg, fed: FDLoRAConfig, base_params: Params,
                 device="cuda", paged_backend: Optional[str] = None):
        self.device = resolve_device(device)
        self.paged_backend = resolve_backend(cfg, paged_backend,
                                             self.device).paged_backend
        self.model, self.cfg, self.fed = model, cfg, fed
        self.base = base_params
        self.scale = lora_scale(cfg)
        self.inner_opt = adamw(lr=fed.inner_lr,
                               weight_decay=fed.inner_weight_decay)
        self.outer_opt = make_outer_optimizer(fed.outer_kind, fed.outer_lr,
                                              fed.outer_momentum)
        self._step = make_lora_train_step(model, cfg, self.inner_opt,
                                          paged_backend=self.paged_backend)
        self._fused_eval = make_fused_eval_fn(model, cfg,
                                              paged_backend=self.paged_backend)
        self.history: List[Dict] = []

    def _dev(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    # ---- Stage 1 ---------------------------------------------------------
    def stage1(self, batchers) -> List[ClientState]:
        fed = self.fed
        clients: List[ClientState] = []
        for i in range(fed.n_clients):
            ad = init_adapters(self.cfg, seed=fed.seed * 1000 + i,
                               device=self.device)
            st = self.inner_opt.init(ad)
            for _ in range(fed.stage1_steps):
                ad, st, _ = self._step(self.base, ad, st,
                                       self._dev(batchers[i].sample()))
            clients.append(ClientState(
                personalized=ad, global_copy=ad, inner_opt_state=st,
                fusion_weights=np.array([0.5, 0.5], np.float32)))
        # Eq. 6: the global LoRA starts at the client mean
        self.theta_s = tree_mean([c.personalized for c in clients])
        self.outer_state = self.outer_opt.init(self.theta_s)
        return clients

    # ---- Stage 2 ---------------------------------------------------------
    def stage2_round(self, t: int, clients: Sequence[ClientState], batchers):
        fed = self.fed
        down = tree_bytes(self.theta_s)
        client_thetas = []
        round_losses: List[torch.Tensor] = []
        for i, c in enumerate(clients):
            theta_i = self.theta_s                      # line 11: re-dispatch
            c.comm_bytes_down += down
            st = c.inner_opt_state
            for _ in range(fed.inner_steps):            # line 12: K steps
                theta_i, st, m = self._step(self.base, theta_i, st,
                                            self._dev(batchers[i].sample()))
                round_losses.append(m["loss"])  # device scalar; read once
            c.inner_opt_state = st
            c.global_copy = theta_i
            if fed.sync_every and t % fed.sync_every == 0:  # lines 13-15
                c.personalized = theta_i
            client_thetas.append(theta_i)
            c.comm_bytes_up += tree_bytes(theta_i)
        # lines 17-18: the server's outer update
        self.theta_s, self.outer_state, delta = outer_step(
            self.outer_opt, self.theta_s, self.outer_state, client_thetas)
        # mean over every client's every inner step
        mean_loss = (float(np.mean(torch.stack(round_losses).cpu().numpy()))
                     if round_losses else float("nan"))
        self.history.append({"round": t, "loss": mean_loss})
        return delta

    def stage2(self, clients, batchers,
               on_round: Optional[Callable[[int, Sequence[ClientState]],
                                           None]] = None):
        """T outer rounds; ``on_round(t, clients)`` fires after each round
        (e.g. :meth:`publish` into a live ``AdapterRegistry``)."""
        for t in range(1, self.fed.rounds + 1):
            self.stage2_round(t, clients, batchers)
            if on_round is not None:
                on_round(t, clients)

    # ---- Stage 3 ---------------------------------------------------------
    def fused_eval_loss(self, c: ClientState, w, batch) -> float:
        """The AdaFusion objective of client ``c`` at weights ``w`` on a
        numpy ``batch``."""
        loss, _ = self._fused_eval(self.base, c.personalized, self.theta_s,
                                   np.asarray(w, np.float32), self._dev(batch))
        return float(loss)

    def stage3(self, clients: Sequence[ClientState], batchers):
        for i, c in enumerate(clients):
            q = batchers[i].few_shot(self.fed.few_shot_k)
            w, _ = fusion_lib.adafusion(
                lambda w: self.fused_eval_loss(c, w, q),
                method=self.fed.fusion_method, steps=self.fed.fusion_steps,
                lam=self.fed.fusion_l1, seed=self.fed.seed * 7 + i)
            c.fusion_weights = w

    # ---- the whole of Algorithm 1 ------------------------------------------
    def fit(self, batchers) -> List[ClientState]:
        clients = self.stage1(batchers)
        self.stage2(clients, batchers)
        self.stage3(clients, batchers)
        return clients

    # ---- serving side -------------------------------------------------------
    def fused_adapters(self, c: ClientState) -> Params:
        return merge(c.personalized, self.theta_s, c.fusion_weights)

    def publish(self, registry, clients: Sequence[ClientState],
                client_ids: Optional[Sequence[Any]] = None) -> Dict[Any, int]:
        """Register every client's Eq. 7 fused adapter into a serving
        ``serving.registry.AdapterRegistry`` (re-registration bumps the
        client's ``version()`` and the bank epoch).  Returns
        ``{client_id: slot}``."""
        if client_ids is None:
            client_ids = [f"client{i}" for i in range(len(clients))]
        return {cid: registry.register(cid, self.fused_adapters(c))
                for cid, c in zip(client_ids, clients)}
