"""``Model``: the port's uniform interface over every model family.

Mirrors ``repro/models/api.py::Model``.  ``Model.forward(params, batch,
adapters)`` takes a dict ``batch``:

* decoder families: {"tokens": (B, S)}, plus "patch_embeds" (B, P, d) for
  the VLM (prepended to the text);
* the encoder-decoder: {"enc_embeds": (B, T, d), "tokens": (B, S)}.

``Model.decode_step`` serves both: paged or contiguous for decoders, the
contiguous cache of ``models/encdec.py`` for the encoder-decoder, which,
as in the reference, refuses banked adapters, paged caches and paged
prefill.  A ``Model`` is bound to a device (``"cuda"`` unless the caller
asks for the CPU; a missing card raises).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import encdec
from repro_torch.models import model as dec

Params = Dict[str, Any]


class Model:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int = 0, shard=None) -> Params:
        """Random weights from ``seed``; ``shard`` (size, rank): that
        rank's shard of a ``size``-way model axis, cut as it is drawn
        (``model.init_params``)."""
        if self.cfg.is_encdec:
            return encdec.init_params(self.cfg, seed, self.device,
                                      shard=shard)
        return dec.init_params(self.cfg, seed, self.device, shard=shard)

    def param_specs(self) -> Params:
        """Partition specs (``core/partition.P``) of :meth:`init`'s tree."""
        if self.cfg.is_encdec:
            return encdec.param_specs(self.cfg)
        return dec.param_specs(self.cfg)

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                adapters: Optional[Params] = None, lora_scale: float = 1.0,
                last_only: bool = False,
                adapter_ids: Optional[torch.Tensor] = None,
                paged_backend: Optional[str] = None, tp=None, dp=None,
                need_aux: bool = True):
        """batch -> (logits (B, S, V) fp32, the MoE aux loss: an fp32
        scalar, 0 for a model without MoE layers).  A VLM's logits cover
        its P patch positions, then the S text positions.  ``tp``: a
        model group (``models/tensor_parallel.py``), the params and
        adapters this rank's shards, the logits its vocabulary block (or
        whole: ``tensor_parallel.vocab_split``).
        ``dp``: a data group, the batch this rank's rows (``need_aux``:
        ``model.forward``); the encoder-decoder, which has no MoE layer,
        reads no ``dp``."""
        cfg = self.cfg
        if cfg.is_encdec:
            if adapter_ids is not None:
                raise NotImplementedError("multi-tenant banked adapters are "
                                          "decoder-family only")
            return encdec.forward(params, batch["enc_embeds"],
                                  batch["tokens"], cfg, adapters, lora_scale,
                                  paged_backend=paged_backend, tp=tp)
        extra = batch.get("patch_embeds") if cfg.family == "vlm" else None
        return dec.forward(params, batch["tokens"], cfg, adapters,
                           lora_scale, last_only=last_only,
                           adapter_ids=adapter_ids,
                           paged_backend=paged_backend, extra_embeds=extra,
                           tp=tp, dp=dp, need_aux=need_aux)

    def init_decode_cache(self, batch: int, cache_len: int,
                          tp=None) -> Params:
        """The fixed path's cache; ``tp``: the rank's kv heads."""
        if self.cfg.is_encdec:
            return encdec.init_decode_cache(self.cfg, batch, cache_len,
                                            self.device, tp=tp)
        return dec.init_decode_cache(self.cfg, batch, cache_len, self.device,
                                     tp=tp)

    def decode_cache_specs(self) -> Params:
        if self.cfg.is_encdec:
            return encdec.decode_cache_specs(self.cfg)
        return dec.decode_cache_specs(self.cfg)

    def init_paged_decode_cache(self, num_blocks: int, block_size: int,
                                kv_dtype: str = "f32",
                                num_slots: Optional[int] = None,
                                tp=None) -> Params:
        """K/V pools of ``num_blocks`` blocks; a model with mamba layers
        also needs ``num_slots``, its rows of recurrent state.  ``tp``:
        the pools hold the rank's kv heads."""
        self.check_paged()
        return dec.init_paged_decode_cache(self.cfg, num_blocks, block_size,
                                           self.device, kv_dtype=kv_dtype,
                                           num_slots=num_slots, tp=tp)

    def check_paged(self) -> None:
        """Refuse paged serving of the encoder-decoder, which decodes on
        the fixed path only, as in the reference (with or without a
        mesh)."""
        if self.cfg.is_encdec:
            raise NotImplementedError("paged decoding is decoder-family only")

    def paged_decode_cache_specs(self, kv_dtype: str = "f32") -> Params:
        self.check_paged()
        return dec.paged_decode_cache_specs(self.cfg, kv_dtype)

    def prefill_step(self, params: Params, cache: Params, tokens, pos, n_new,
                     adapters: Optional[Params] = None,
                     lora_scale: float = 1.0,
                     adapter_ids: Optional[torch.Tensor] = None,
                     block_tables: Optional[torch.Tensor] = None,
                     paged_backend: Optional[str] = None, tp=None,
                     dp=None):
        """Chunked paged prefill; returns (logits (B, T, V), cache).
        ``tp``: this rank's shards, its block of the vocabulary; ``dp``:
        the rows this rank's block of the slots."""
        if self.cfg.is_encdec:
            raise NotImplementedError("paged prefill is decoder-family only")
        return dec.prefill_step(params, cache, tokens, pos, n_new, self.cfg,
                                adapters, lora_scale, adapter_ids=adapter_ids,
                                block_tables=block_tables,
                                paged_backend=paged_backend, tp=tp, dp=dp)

    def verify_step(self, params: Params, cache: Params, tokens, pos, n_new,
                    adapters: Optional[Params] = None,
                    lora_scale: float = 1.0,
                    adapter_ids: Optional[torch.Tensor] = None,
                    block_tables: Optional[torch.Tensor] = None,
                    paged_backend: Optional[str] = None, tp=None, dp=None):
        """Speculative verification: the same dataflow as
        :meth:`prefill_step`, whose logits the caller reads at every chunk
        position."""
        return self.prefill_step(params, cache, tokens, pos, n_new,
                                 adapters=adapters, lora_scale=lora_scale,
                                 adapter_ids=adapter_ids,
                                 block_tables=block_tables,
                                 paged_backend=paged_backend, tp=tp, dp=dp)

    def decode_step(self, params: Params, cache: Params, tokens, pos,
                    adapters: Optional[Params] = None, lora_scale: float = 1.0,
                    adapter_ids: Optional[torch.Tensor] = None,
                    block_tables: Optional[torch.Tensor] = None,
                    paged_backend: Optional[str] = None, tp=None, dp=None):
        """One decode step, paged (``block_tables``, per-row ``pos``) or
        contiguous (int ``pos``); returns (logits (B, 1, V), cache).  The
        encoder-decoder steps its contiguous cache only, its cross K/V
        filled by ``encdec.prefill_cross``.  ``tp``: this rank's shards,
        the logits its block of the vocabulary (whole where the group does
        not split it); ``dp``: the rows this rank's block of the slots."""
        if self.cfg.is_encdec:
            if adapter_ids is not None or block_tables is not None:
                raise NotImplementedError("multi-tenant banked adapters and "
                                          "paged decoding are decoder-family "
                                          "only")
            return encdec.decode_step(params, cache, tokens, pos, self.cfg,
                                      adapters, lora_scale,
                                      paged_backend=paged_backend, tp=tp)
        return dec.decode_step(params, cache, tokens, pos, self.cfg, adapters,
                               lora_scale, adapter_ids=adapter_ids,
                               block_tables=block_tables,
                               paged_backend=paged_backend, tp=tp, dp=dp)


def get_model(cfg, device="cuda") -> Model:
    return Model(cfg, device)
