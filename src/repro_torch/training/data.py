"""Tokenizer and the synthetic OLAP workloads.

``ByteTokenizer`` is the serving path's byte-level tokenizer.  The
workload generators are copied verbatim from the reference (the port
imports nothing of it), so that the same ``(seed, i)`` gives the same
strings on both sides: free-text review rows for summarization,
corrupted records for data correction and entity pairs for fuzzy joins,
each drawn from a ``random.Random`` seeded by a hash of its salt.
``train_batch`` mixes the three tasks into language-model batches that
are a pure function of ``(seed, step)``: a restarted trainer replays
the same batches with no data server.
"""
from __future__ import annotations

import dataclasses
import hashlib
import random
import string
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


class ByteTokenizer:
    """Byte-level tokenizer: ids 0..3 special, 4..259 bytes."""
    PAD, BOS, EOS, SEP = 0, 1, 2, 3
    OFFSET = 4

    def __init__(self, vocab_size: int = 260):
        assert vocab_size >= 260
        self.vocab_size = vocab_size

    def encode(self, text: str, *, bos: bool = False,
               eos: bool = False) -> List[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        bs = bytes(i - self.OFFSET for i in ids
                   if i >= self.OFFSET and i - self.OFFSET < 256)
        return bs.decode("utf-8", errors="replace")

    def pad_batch(self, rows: List[List[int]], *, seq_len: int,
                  align: str = "right") -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens [B, S], lengths [B]); rows are clipped/padded."""
        B = len(rows)
        out = np.full((B, seq_len), self.PAD, np.int32)
        lens = np.zeros((B,), np.int32)
        for i, r in enumerate(rows):
            r = r[:seq_len]
            lens[i] = len(r)
            if align == "right":
                out[i, :len(r)] = r
            else:
                out[i, seq_len - len(r):] = r
        return out, lens


# ---------------------------------------------------------------------------
# synthetic text building blocks
# ---------------------------------------------------------------------------

_PRODUCTS = ["headphones", "keyboard", "monitor", "webcam", "microphone",
             "laptop stand", "usb hub", "desk lamp", "office chair",
             "mouse pad", "router", "speaker", "charger", "tablet",
             "smartwatch", "printer"]
_ADJ_POS = ["great", "excellent", "fantastic", "solid", "amazing",
            "reliable", "superb", "crisp"]
_ADJ_NEG = ["terrible", "awful", "flimsy", "noisy", "laggy",
            "disappointing", "cheap", "broken"]
_FILLER = ["I bought this last month.", "Shipping was fast.",
           "The packaging was fine.", "My friend recommended it.",
           "I use it every day.", "Setup took five minutes.",
           "Color matches the photos.", "Works with my setup."]
_CATEGORIES = ["python", "javascript", "golang", "rust", "java", "ruby",
               "swift", "kotlin", "csharp", "scala"]
_COMPANIES = ["Acme Corp", "Globex", "Initech", "Umbrella", "Stark Labs",
              "Wayne Tech", "Hooli", "Vandelay", "Wonka Industries",
              "Tyrell Corp"]
_SUFFIXES = ["Inc.", "LLC", "Co.", "Corporation", "Group", "Holdings", ""]


@dataclass
class Row:
    text: str          # model input (the "column value")
    target: str        # ground-truth output for the LLM operator
    meta: Dict = dataclasses.field(default_factory=dict)


def _rng(seed: int, *salt) -> random.Random:
    h = hashlib.sha256(repr((seed,) + salt).encode()).digest()
    return random.Random(int.from_bytes(h[:8], "big"))


# --- workload 1: summarization (reviews -> "<sentiment> <product>") -------

def gen_review(seed: int, i: int) -> Row:
    r = _rng(seed, "review", i)
    prod = r.choice(_PRODUCTS)
    pos = r.random() < 0.5
    adj = r.choice(_ADJ_POS if pos else _ADJ_NEG)
    n_fill = r.randint(2, 5)
    fillers = r.sample(_FILLER, n_fill)
    sent = f"The {prod} is {adj}."
    pieces = fillers[:n_fill // 2] + [sent] + fillers[n_fill // 2:]
    return Row(text=" ".join(pieces),
               target=f"{'positive' if pos else 'negative'} {prod}",
               meta={"sentiment": pos, "product": prod})


# --- workload 2: data correction (typo'd category -> canonical) -----------

def _typo(word: str, r: random.Random) -> str:
    if len(word) < 3:
        return word
    kind = r.randrange(4)
    i = r.randrange(1, len(word) - 1)
    if kind == 0:     # swap
        return word[:i] + word[i + 1] + word[i] + word[i + 2:]
    if kind == 1:     # drop
        return word[:i] + word[i + 1:]
    if kind == 2:     # double
        return word[:i] + word[i] + word[i:]
    return word[:i] + r.choice(string.ascii_lowercase) + word[i + 1:]


def gen_typo(seed: int, i: int) -> Row:
    r = _rng(seed, "typo", i)
    cat = r.choice(_CATEGORIES)
    bad = _typo(cat, r)
    # ~20% duplicated rows: the result-cache workload signal
    if r.random() < 0.2:
        r2 = _rng(seed, "typo", max(i - r.randint(1, 8), 0))
        cat = r2.choice(_CATEGORIES)
        bad = _typo(cat, r2)
    return Row(text=bad, target=cat, meta={"clean": cat})


# --- workload 3: fuzzy join (entity pair -> same/different) ----------------

def _variant(name: str, r: random.Random) -> str:
    v = name
    if r.random() < 0.5:
        v = v.replace(" ", ", ") if r.random() < 0.3 else v
    suf = r.choice(_SUFFIXES)
    if suf and r.random() < 0.7:
        v = f"{v} {suf}"
    if r.random() < 0.3:
        v = v.lower()
    if r.random() < 0.2:
        v = v.replace("o", "0", 1)
    return v


def gen_entity_pair(seed: int, i: int) -> Row:
    r = _rng(seed, "join", i)
    a = r.choice(_COMPANIES)
    same = r.random() < 0.5
    b = a if same else r.choice([c for c in _COMPANIES if c != a])
    return Row(text=f"{_variant(a, r)} | {_variant(b, r)}",
               target="same" if same else "different",
               meta={"same": same})


WORKLOADS = {
    "summarize": gen_review,
    "correct": gen_typo,
    "join": gen_entity_pair,
}

PROMPTS = {
    "summarize": "summarize: ",
    "correct": "fix: ",
    "join": "match: ",
}


def workload_rows(name: str, n: int, *, seed: int = 0) -> List[Row]:
    gen = WORKLOADS[name]
    return [gen(seed, i) for i in range(n)]


# ---------------------------------------------------------------------------
# LM training batches (mixture of all three tasks, prompt-formatted)
# ---------------------------------------------------------------------------

def format_example(task: str, row: Row, tok: ByteTokenizer) -> List[int]:
    """``<bos> prompt text <sep> target <eos>`` — loss over the whole row."""
    ids = tok.encode(PROMPTS[task] + row.text, bos=True)
    ids += [tok.SEP] + tok.encode(row.target, eos=True)
    return ids


def train_batch(step: int, *, batch: int, seq_len: int,
                tok: ByteTokenizer, seed: int = 0,
                tasks: Sequence[str] = ("summarize", "correct", "join")):
    """Deterministic (seed, step) -> batch of numpy arrays ``tokens``,
    ``labels`` (int32 [batch, seq_len]) and ``weights`` (f32, 0 on
    padding); restart-safe by construction."""
    rows = []
    for b in range(batch):
        r = _rng(seed, "mix", step, b)
        task = tasks[r.randrange(len(tasks))]
        row = WORKLOADS[task](seed * 97 + 13, step * batch + b)
        rows.append(format_example(task, row, tok))
    toks, _ = tok.pad_batch(rows, seq_len=seq_len + 1)
    tokens = toks[:, :-1]
    labels = toks[:, 1:].copy()
    labels[labels == tok.PAD] = 0
    weights = (toks[:, 1:] != tok.PAD).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "weights": weights}


def eval_rows(task: str, n: int, *, seed: int = 10_000) -> List[Row]:
    """Held-out rows (disjoint salt from training)."""
    gen = WORKLOADS[task]
    return [gen(seed, i) for i in range(n)]
