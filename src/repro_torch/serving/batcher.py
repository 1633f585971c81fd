"""Request batching (paper §3.3): group rows to amortize invocation cost.

Buckets prompts by padded length (powers of two between min and max) so
the engine runs one prefill shape per bucket instead of one per
distinct length.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class Request:
    rid: int
    prompt_ids: List[int]            # full prompt, or row suffix when split
    max_new: int
    # filled during serving
    out_ids: List[int] = field(default_factory=list)
    done: bool = False
    cache_key: Optional[tuple] = None
    text: Optional[str] = None       # decoded output, set on completion
    truncated: bool = False          # prompt clipped to the top bucket
    follower: bool = False           # riding on an in-flight duplicate
    # cascade acceptance signal: min answer-token probability over every
    # emitted token (sampler.token_confidence), updated as the
    # decode step's confidence output lands.  inf until the first token
    # (an empty output is "never doubted"); followers and result-cache
    # hits inherit their leader's value.
    confidence: float = float("inf")
    # prefix sharing: template token prefix split off at submit()
    prefix_ids: Optional[List[int]] = None
    prefix_key: Optional[tuple] = None   # PrefixCache key (ids, version)
    # original prompt text, kept so a scheduler can re-submit the row to
    # a replacement engine after a mid-tick engine fault (quarantine)
    src: Optional[str] = None


def bucket_len(n: int, buckets: Sequence[int]) -> int:
    if not buckets:
        return n
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Batcher:
    """FIFO admission with length-bucketing."""

    def __init__(self, buckets: Sequence[int] = (32, 64, 128, 256, 512)):
        self.buckets = tuple(sorted(buckets))
        self.queue: List[Request] = []

    def add(self, req: Request) -> None:
        self.queue.append(req)

    def take(self, n: int) -> List[Request]:
        """Up to n requests sharing one length bucket AND one prefix
        entry (FIFO head defines both so no request starves).  Prefix
        uniformity matters because admission seeds every row of the
        batch from a single shared prefix state; requests are bucketed
        on their *suffix* when a prefix was split off."""
        if not self.queue or n <= 0:
            return []
        head = self.queue[0]
        head_b = bucket_len(len(head.prompt_ids), self.buckets)
        out, rest = [], []
        for r in self.queue:
            if len(out) < n and r.prefix_key == head.prefix_key \
                    and bucket_len(len(r.prompt_ids),
                                   self.buckets) == head_b:
                out.append(r)
            else:
                rest.append(r)
        self.queue = rest
        return out

    def __len__(self) -> int:
        return len(self.queue)
