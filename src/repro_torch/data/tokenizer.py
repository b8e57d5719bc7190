"""Byte-level tokenizer with a handful of special tokens.

The port's own copy of ``repro/data/tokenizer.py`` (numpy only).

The paper fine-tunes over natural-language prompts; offline we use synthetic
corpora, so a byte-level vocabulary (256 bytes + specials) keeps the pipeline
real (tokenize → pad → mask) without shipping a trained BPE model.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

PAD = 256
BOS = 257
EOS = 258
VOCAB_SIZE = 260  # 256 bytes + pad/bos/eos + 1 spare


class ByteTokenizer:
    vocab_size = VOCAB_SIZE
    pad_id = PAD
    bos_id = BOS
    eos_id = EOS

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [BOS] + ids
        if add_eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


def pad_batch(seqs: Sequence[Sequence[int]], max_len: int,
              masks: Sequence[Sequence[int]] = None):
    """Right-pad to (N, max_len); returns (tokens, loss_mask) int32 arrays.

    ``masks`` (same nesting) marks which *input* positions contribute to the
    SFT loss (answer tokens); pad positions are always masked out.
    """
    n = len(seqs)
    toks = np.full((n, max_len), PAD, dtype=np.int32)
    lm = np.zeros((n, max_len), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[:max_len]
        toks[i, :len(s)] = s
        if masks is not None:
            m = list(masks[i])[:max_len]
            lm[i, :len(m)] = m
        else:
            lm[i, :len(s)] = 1
    return toks, lm
