"""Self-drafting for speculative decoding: prompt-lookup n-gram proposals.

Decode is one token per model evaluation — the serving throughput ceiling
once prefill is chunked and prefix-cached.  Speculative decoding breaks it
by *guessing* the next K tokens cheaply and verifying all of them with ONE
model evaluation: the chunked paged prefill path already scores a (K+1)-
token chunk causally against the pool, and PR 3 established that chunk
logits are bitwise-equal to feeding the same tokens one decode step at a
time.  So greedy acceptance (keep the longest run where every drafted
token equals the model's own greedy choice at the previous position)
yields a token stream bitwise-identical to non-speculative greedy
decoding — the draft only changes *when* tokens are computed, never
*which*.

The drafter here is the cheapest one that works on serving traffic:
**prompt lookup** (as in assisted generation / vLLM's ngram speculator).
No second model — the proposal is copied from the request's own history:
find the most recent earlier occurrence of the history's trailing n-gram
and propose the tokens that followed it.  Repetitive output (templated
logs, code, per-client boilerplate — the FDLoRA serving regime) gives
long matches and high acceptance; adversarial output just degrades to
zero-length drafts, which cost nothing (the slot rides the verify
dispatch as a plain 1-token feedback row).
"""
from __future__ import annotations

from typing import List, Sequence


def propose_draft(history: Sequence[int], k: int, max_ngram: int = 3,
                  min_ngram: int = 1) -> List[int]:
    """Propose up to ``k`` continuation tokens for ``history`` by prompt
    lookup: for the longest ``n`` in ``[min_ngram, max_ngram]`` whose
    trailing n-gram reoccurs earlier in ``history``, copy the tokens that
    followed the MOST RECENT earlier occurrence with a FULL ``k``-token
    continuation (falling back to the most recent occurrence outright when
    none has one).  Returns ``[]`` when no n-gram matches (the caller
    falls back to plain decode) — never a guess, so a non-repetitive
    stream costs nothing extra.

    Recency mirrors the current context best for templated text, but
    recency ALONE is a trap: in a constant or periodic run the most
    recent occurrence sits flush against the tail, leaving a 1-token
    continuation — exactly the stream that should draft ``k`` every
    round.  Requiring a full continuation first makes the drafter step
    back one period and copy a whole window.

    The proposal may still be shorter than ``k`` when every match sits
    near the end of the history (fewer than ``k`` tokens follow it)."""
    h = [int(t) for t in history]
    n_hist = len(h)
    if k <= 0 or n_hist < min_ngram + 1:
        return []
    for n in range(min(max_ngram, n_hist - 1), min_ngram - 1, -1):
        pat = h[n_hist - n:]
        fallback: List[int] = []
        for start in range(n_hist - n - 1, -1, -1):
            if h[start:start + n] == pat:
                cont = h[start + n:start + n + k]
                if len(cont) == k:
                    return cont
                if not fallback:
                    fallback = cont        # most recent partial match
        if fallback:
            return fallback
    return []
