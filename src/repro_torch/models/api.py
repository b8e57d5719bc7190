"""``Model``: the port's uniform interface over the decoder.

Mirrors ``repro/models/api.py::Model`` for the dense and MoE families.  A
``Model`` is bound to a device (``"cuda"`` unless the caller asks for the CPU; a
missing card raises).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import model as dec

Params = Dict[str, Any]


class Model:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> Params:
        return dec.init_params(self.cfg, seed, self.device)

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                adapters: Optional[Params] = None, lora_scale: float = 1.0,
                last_only: bool = False,
                adapter_ids: Optional[torch.Tensor] = None,
                paged_backend: Optional[str] = None):
        """batch = {"tokens": (B, S)} -> (logits (B, S, V) fp32, the MoE
        aux loss: an fp32 scalar, 0 for a dense model)."""
        return dec.forward(params, batch["tokens"], self.cfg, adapters,
                           lora_scale, last_only=last_only,
                           adapter_ids=adapter_ids,
                           paged_backend=paged_backend)

    def init_decode_cache(self, batch: int, cache_len: int) -> Params:
        return dec.init_decode_cache(self.cfg, batch, cache_len, self.device)

    def init_paged_decode_cache(self, num_blocks: int, block_size: int,
                                kv_dtype: str = "f32") -> Params:
        return dec.init_paged_decode_cache(self.cfg, num_blocks, block_size,
                                           self.device, kv_dtype=kv_dtype)

    def prefill_step(self, params: Params, cache: Params, tokens, pos, n_new,
                     adapters: Optional[Params] = None,
                     lora_scale: float = 1.0,
                     adapter_ids: Optional[torch.Tensor] = None,
                     block_tables: Optional[torch.Tensor] = None,
                     paged_backend: Optional[str] = None):
        """Chunked paged prefill; returns (logits (B, T, V), cache)."""
        return dec.prefill_step(params, cache, tokens, pos, n_new, self.cfg,
                                adapters, lora_scale, adapter_ids=adapter_ids,
                                block_tables=block_tables,
                                paged_backend=paged_backend)

    def verify_step(self, params: Params, cache: Params, tokens, pos, n_new,
                    adapters: Optional[Params] = None,
                    lora_scale: float = 1.0,
                    adapter_ids: Optional[torch.Tensor] = None,
                    block_tables: Optional[torch.Tensor] = None,
                    paged_backend: Optional[str] = None):
        """Speculative verification: the same dataflow as
        :meth:`prefill_step`, whose logits the caller reads at every chunk
        position."""
        return self.prefill_step(params, cache, tokens, pos, n_new,
                                 adapters=adapters, lora_scale=lora_scale,
                                 adapter_ids=adapter_ids,
                                 block_tables=block_tables,
                                 paged_backend=paged_backend)

    def decode_step(self, params: Params, cache: Params, tokens, pos,
                    adapters: Optional[Params] = None, lora_scale: float = 1.0,
                    adapter_ids: Optional[torch.Tensor] = None,
                    block_tables: Optional[torch.Tensor] = None,
                    paged_backend: Optional[str] = None):
        """One decode step, paged (``block_tables``, per-row ``pos``) or
        contiguous (int ``pos``); returns (logits (B, 1, V), cache)."""
        return dec.decode_step(params, cache, tokens, pos, self.cfg, adapters,
                               lora_scale, adapter_ids=adapter_ids,
                               block_tables=block_tables,
                               paged_backend=paged_backend)


def get_model(cfg, device="cuda") -> Model:
    return Model(cfg, device)
