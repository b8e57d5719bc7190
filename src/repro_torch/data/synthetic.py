"""Synthetic datasets mirroring the paper's two evaluation scenarios.

The port's own copy of ``repro/data/synthetic.py`` (numpy, and torch for
``answer_accuracy``'s forward).

Scenario-1 — log-based anomaly detection (BGL / Spirit / Thunderbird style):
samples are sliding windows of parsed log templates; the label is whether the
window contains an anomalous event. Each "source" (≈ a LogHub dataset) has
its own template pool and anomaly signatures, so different sources induce
genuinely different conditional distributions — the non-IID axis.

Scenario-2 — medical multiple-choice QA (ChemProt/MQP/PubMedQA/RCT/USMLE
style): five synthetic sub-tasks with distinct surface forms; the label is
the correct option letter. The class partitioned by Dirichlet(α) is the
sub-task id.

Both follow the paper's SFT format: a prompt, and a short answer span; the
loss mask covers only the answer tokens (appendix A1/A2 templates, reduced to
byte-tokenizer scale).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer


@dataclasses.dataclass
class Example:
    prompt: str
    answer: str
    cls: int  # class id used for the Dirichlet non-IID partition


# ---------------------------------------------------------------------------
# Scenario 1: log anomaly detection
# ---------------------------------------------------------------------------

_LOG_SOURCES = {
    0: {  # BGL-like
        "normal": ["cache parity ok", "fan speed set", "job start", "net link up",
                   "ciod io ready", "heartbeat ok"],
        "anomaly": ["L3 ecc uncorrectable", "kernel panic cpu0", "ddr failing addr"],
    },
    1: {  # Spirit-like
        "normal": ["sshd session open", "cron job ran", "nfs mount ok", "temp nominal",
                   "disk scrub pass"],
        "anomaly": ["scsi bus reset", "raid degraded", "oom killer invoked"],
    },
    2: {  # Thunderbird-like
        "normal": ["ib port active", "mpi init ok", "lustre ping", "pbs epilogue",
                   "power rail ok"],
        "anomaly": ["machine check fatal", "ib link flap", "ecc threshold exceeded"],
    },
}


def gen_log_dataset(rng: np.random.Generator, n: int, source: int,
                    window: int = 4, anomaly_rate: float = 0.35) -> List[Example]:
    src = _LOG_SOURCES[source % len(_LOG_SOURCES)]
    out = []
    for _ in range(n):
        is_anom = rng.random() < anomaly_rate
        lines = list(rng.choice(src["normal"], size=window))
        if is_anom:
            k = rng.integers(1, 3)
            pos = rng.choice(window, size=k, replace=False)
            for p in pos:
                lines[p] = str(rng.choice(src["anomaly"]))
        prompt = "logs: " + " | ".join(lines) + " anomaly? "
        out.append(Example(prompt, "yes" if is_anom else "no", cls=source))
    return out


# ---------------------------------------------------------------------------
# Scenario 2: medical multiple-choice QA (5 synthetic sub-tasks)
# ---------------------------------------------------------------------------

_MED_TASKS = [
    # (name, [(clue, answer_letter)...], options string)
    ("chemprot", [("x inhibits y", "a"), ("x activates y", "b"),
                  ("x binds y", "c")], "a)inhibitor b)activator c)substrate"),
    ("mqp", [("same meaning", "a"), ("different meaning", "b")],
     "a)similar b)dissimilar"),
    ("pubmedqa", [("evidence supports", "a"), ("evidence refutes", "b"),
                  ("evidence unclear", "c")], "a)yes b)no c)maybe"),
    ("rct", [("background info", "a"), ("methods used", "b"), ("results show", "c"),
             ("we conclude", "d")], "a)background b)methods c)results d)conclusions"),
    ("usmle", [("fever cough", "a"), ("chest pain", "b"), ("headache aura", "c")],
     "a)influenza b)angina c)migraine"),
]


def gen_medical_dataset(rng: np.random.Generator, n: int, task: int) -> List[Example]:
    name, clues, options = _MED_TASKS[task % len(_MED_TASKS)]
    out = []
    for _ in range(n):
        clue, ans = clues[rng.integers(len(clues))]
        noise = "".join(rng.choice(list("abcdefgh "), size=6))
        prompt = f"[{name}] {clue} {noise} {options} ans: "
        out.append(Example(prompt, ans, cls=task))
    return out


# ---------------------------------------------------------------------------
# Generic text for base-model pretraining ("basic knowledge")
# ---------------------------------------------------------------------------

def gen_pretrain_text(rng: np.random.Generator, n: int, length: int = 64) -> List[str]:
    words = ["the", "log", "system", "error", "ok", "yes", "no", "a", "b", "c",
             "patient", "result", "job", "link", "cache", "answer", "is"]
    return [" ".join(rng.choice(words, size=length // 4)) for _ in range(n)]


# ---------------------------------------------------------------------------
# SFT encoding
# ---------------------------------------------------------------------------

def encode_sft(examples: Sequence[Example], tok: ByteTokenizer, max_len: int
               ) -> Dict[str, np.ndarray]:
    """Returns {"tokens": (N, L), "loss_mask": (N, L), "cls": (N,)}."""
    from repro_torch.data.tokenizer import pad_batch
    seqs, masks = [], []
    for ex in examples:
        p = tok.encode(ex.prompt, add_bos=True)
        a = tok.encode(ex.answer, add_bos=False, add_eos=True)
        seqs.append(p + a)
        masks.append([0] * len(p) + [1] * len(a))
    toks, lm = pad_batch(seqs, max_len, masks)
    return {"tokens": toks, "loss_mask": lm,
            "cls": np.array([ex.cls for ex in examples], dtype=np.int32)}


def answer_logits(model, params, adapters, examples: Sequence[Example],
                  tok: ByteTokenizer, max_len: int, lora_scale: float,
                  batch_size: int = 32):
    """(N, V) fp32 logits at each example's answer position, the last
    prompt token ``min(len(prompt), max_len) - 1``: the prompts are
    right-padded to ``max_len`` by ``pad_batch`` and run through
    ``model.forward`` ``batch_size`` at a time, under ``torch.no_grad()``,
    on the model's device and backend."""
    import torch
    from repro_torch.data.tokenizer import pad_batch

    out = []
    with torch.no_grad():
        for i in range(0, len(examples), batch_size):
            prompts = [tok.encode(ex.prompt)
                       for ex in examples[i:i + batch_size]]
            last = torch.as_tensor([min(len(p), max_len) - 1
                                    for p in prompts], device=model.device)
            toks, _ = pad_batch(prompts, max_len)
            logits, _ = model.forward(
                params, {"tokens": torch.as_tensor(toks).to(model.device)},
                adapters=adapters, lora_scale=lora_scale)
            out.append(logits[torch.arange(len(prompts),
                                           device=model.device), last])
    return torch.cat(out)


def answer_accuracy(model, cfg, params, adapters, examples: Sequence[Example],
                    tok: ByteTokenizer, max_len: int, lora_scale: float,
                    batch_size: int = 32) -> float:
    """Exact-match on the first answer token (greedy), the paper's
    'accuracy' metric reduced to byte scale: for scenario-1 'yes'/'no' and
    scenario-2 option letters, the first byte determines the answer."""
    if not examples:
        return 0.0
    preds = answer_logits(model, params, adapters, examples, tok, max_len,
                          lora_scale, batch_size).argmax(-1).cpu().numpy()
    want = np.array([tok.encode(ex.answer, add_bos=False)[0]
                     for ex in examples])
    return int((preds == want).sum()) / len(examples)
