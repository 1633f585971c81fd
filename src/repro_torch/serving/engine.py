"""Serving engine: asynchronous continuous batching over fixed decode slots.

The port of the reference engine: a fixed set of decode slots and two
KV layouts.  The paged one keeps KV in one global pool of fixed-size
blocks shared by all slots plus a per-slot block table; admission
scatters per-row prefill KV into table-addressed blocks, and a shared
template prefix is seeded once and *aliased* by every row's table
instead of copied.  Decode attends through the table — a PyTorch gather
(``"reference"`` backend) or the paged CUDA kernel (``"cuda"``).  The
contiguous one keeps ``api.init_cache(cfg, slots, max_len)``: admission
writes the rows' caches at their slot indices, and decode is one step
of the model's masked decode over all slots at per-slot positions (the
reference vmaps one-row steps, which the batched step equals); it
launches no paged kernel.  ``kv_layout="auto"`` takes the paged layout
unless the family has none or its power-of-two block would hold fewer
than 8 positions.  Either way every int8 linear runs the int8 CUDA
kernel on the cuda backend.

Entry points, as in the reference:

  ``submit(text)``  enqueue a request; duplicate prompts attach as
                    followers to an in-flight leader and never touch a
                    slot; finished prompts short-circuit through the
                    result cache.
  ``step()``        one tick: admit a batch into free slots (one
                    bucketed prefill + one batched insert), run one
                    decode step for all slots, retire finished rows.
  ``drain()``       tick until queue and slots are empty.

``step() == step_finish(step_begin())``.  ``step_begin`` admits and
enqueues the tick's decode on the current CUDA stream without waiting
for it; an admission reads its first sampled tokens back to the host
(as the reference's does), the decode itself is waited on only in
``step_finish``, the tick's one host sync for decode.

Admission prefill is one batched call over ``[n, bucket]`` where the
reference vmaps single rows.  Causal masking keeps right-padding out of
every real position, and each row's real length (``lengths``) keeps it
out of a recurrent family's carried state, so the rows agree; a
prefix-cache entry of the hybrid or of rwkv carries the recurrent states
at the end of the prefix, which ``prefill_from`` resumes for every row
of the admission.  An MoE model's capacity is
decided per row (``cap_tokens`` = the bucket), as in the reference's
single-row prefill, so rows that together pass the 4096-token dropless
limit are still dispatched without drops when each row is under it.
Decode is batched over slots in both packages (its MoE dispatch sees one
token a slot).  Every family is ported; rwkv, vlm and encdec, which have
no paged layout, always serve on the contiguous one.  ``extra_inputs``
is one engine-wide entry that every admitted row gets: ``img_embs``
[n_img, d] (vlm), spliced ahead of each row's text, or ``enc_inputs``
[Te, d] (encdec), the frames its decoder cross-attends to.  An engine
with one keeps no prefix cache.  A vlm row's first token is read at its
last text position, n_img + len - 1 of the image-prefixed sequence, and
its decode starts at n_img + len; the reference reads it at len - 1 and
decodes from len, inside the image's KV (ROADMAP queue 3).  The engine
updates its pools and states in place (``index_copy_``) where the
reference donates them to jit.

``mesh=`` (a ``launch/mesh.py`` ``Mesh``) serves tensor-parallel: the
params are placed by the reference's rule table
(``distributed/sharding.py`` ``shard_params``), so every sharded linear
runs piece by piece, each piece's kernel at its own shape, and the
pieces' outputs are gathered or summed on the mesh's first device.  One
process drives every position (single-controller, as the reference).  A
mesh engine keeps the contiguous layout, as the reference's does (block
gathers would defeat the sharding rules), and places its slot state at
construction: every leaf follows the reference's ``cache_shardings``
(k/v slots over "data", or over "pod" and "data" on a ``("pod",
"data", "model")`` mesh, or where the slots do not divide "data" their
positions, KV heads or else head_dim over "model"; rwkv ``S`` and mamba
``h`` slots and heads; the other recurrent leaves and ``enc_len``
slots), and decode attention and the recurrent scans run where each
piece lives (``models/sharded_cache.py``); an admission hands each data
position its rows, and each position piece of a sequence split its
positions.  Norms, sampling and the leaves a spec
replicates stay on the mesh's first device.  :meth:`Engine.position_bytes`
is what each position holds.
``device=`` and ``mesh=`` together raise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.bridge import to_tensor
from repro_torch.core.compressed import kernel_backend, position_bytes
from repro_torch.kernels.backend import resolve_backend, resolve_device
from repro_torch.models import api
from repro_torch.models import sharded_cache as SC
from repro_torch.serving.batcher import Batcher, Request, bucket_len
from repro_torch.serving.cache import PrefixCache, ResultCache
from repro_torch.serving.paged import BlockTableAllocator
from repro_torch.serving.sampler import SamplingConfig, sample, token_confidence
from repro_torch.training.data import ByteTokenizer

DEFAULT_CHUNK = 64


@dataclass
class EngineStats:
    rows: int = 0
    tokens_out: int = 0
    prefills: int = 0
    decode_steps: int = 0
    cache_hits: int = 0
    truncated: int = 0           # prompts clipped to the top bucket
    peak_inflight: int = 0       # max queued+active requests ever resident
    busy_slot_steps: int = 0     # slot-steps that decoded a live row
    total_slot_steps: int = 0    # slot-steps executed (busy + idle)
    prefix_hits: int = 0         # rows seeded from a shared prefix state
    prefill_tokens: int = 0      # padded prompt tokens actually prefilled
    prefill_tokens_saved: int = 0  # prefix tokens NOT re-prefilled per row
    backend: str = ""            # resolved KernelBackend ("reference"/"cuda")
    kv_blocks_in_use: int = 0    # peak KV blocks reachable
    kv_blocks_shared: int = 0    # peak blocks aliased by >1 slot
    confidence_sum: float = 0.0  # sum of per-row min answer-token prob
    confidence_rows: int = 0     # rows with a finite confidence signal
    wall_s: float = 0.0

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.wall_s if self.wall_s else 0.0

    @property
    def mean_confidence(self) -> float:
        return (self.confidence_sum / self.confidence_rows
                if self.confidence_rows else 0.0)

    @property
    def slot_utilization(self) -> float:
        return (self.busy_slot_steps / self.total_slot_steps
                if self.total_slot_steps else 0.0)


class StepPending(NamedTuple):
    """Handle between ``step_begin`` and ``step_finish``: requests already
    finished at admission, plus the launched decode's ``(tokens,
    confidences)`` device tensors, or ``None`` when no decode ran."""
    finished: List[Request]
    nxt: Any


def _to_device(tree, device):
    """Move a param tree (tensors and QTensors) to ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return None if tree is None else tree.to(device)


class Engine:
    def __init__(self, params, cfg, *, tokenizer: Optional[ByteTokenizer] = None,
                 slots: int = 8, max_len: int = 256,
                 buckets: Sequence[int] = (32, 64, 128),
                 use_result_cache: bool = True, version: str = "base",
                 use_prefix_cache: bool = True,
                 prefix_cache: Optional[PrefixCache] = None,
                 extra_inputs: Optional[Dict] = None,
                 sampling: Optional[SamplingConfig] = None,
                 device=None, mesh=None,
                 backend: str = "auto", kv_layout: str = "auto",
                 kv_block_size: int = 32):
        if device is not None and mesh is not None:
            raise ValueError("pass device= (single-device placement) OR "
                             "mesh= (sharded), not both")
        if kv_layout not in ("auto", "paged", "contiguous"):
            raise ValueError(f"kv_layout must be auto/paged/contiguous, "
                             f"got {kv_layout!r}")
        # the paged block size: the largest power of two <= kv_block_size
        # that divides max_len
        bs = 1
        while bs * 2 <= kv_block_size and max_len % (bs * 2) == 0:
            bs *= 2
        self._paged = (kv_layout != "contiguous" and api.supports_paged(cfg)
                       and mesh is None and not (kv_layout == "auto" and bs < 8))
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.distributed.sharding import shard_params
            self.device = mesh.first_device
            self.params = shard_params(params, cfg, mesh)
            # distinct placements never share prefilled state: the tag keys
            # the prefix cache per placement
            self._placement_tag = "@" + mesh.tag()
        else:
            self.device = resolve_device("cuda" if device is None else device)
            self.params = _to_device(params, self.device)
            self._placement_tag = f"@{self.device}"
        self.backend = resolve_backend(backend, self.device)
        self.cfg = cfg
        self.tok = tokenizer or ByteTokenizer(max(cfg.vocab_size, 260))
        self.slots = slots
        self.max_len = max_len
        cap = max(1, max_len - 1)
        ladder = sorted({min(int(b), cap) for b in buckets if int(b) > 0})
        self.buckets = tuple(ladder) or (cap,)
        self.result_cache = ResultCache() if use_result_cache else None
        self.version = version
        # one engine-wide input (image embeddings or encoder frames) for
        # every row: it sits ahead of or beside the text, so no prefix cache
        self.extra_inputs = {k: v.to(self.device) if torch.is_tensor(v)
                             else to_tensor(v, self.device)
                             for k, v in (extra_inputs or {}).items()}
        img = self.extra_inputs.get("img_embs")
        self._n_img = img.shape[0] if cfg.family == "vlm" and img is not None else 0
        if self._n_img + self.buckets[-1] > max_len - 1:
            raise ValueError(
                f"{self._n_img} image positions and the top bucket {self.buckets[-1]} "
                f"leave no room to decode within max_len {max_len}")
        self.prefix_cache = (
            (prefix_cache if prefix_cache is not None else PrefixCache())
            if use_prefix_cache and api.supports_prefix(cfg) and not self.extra_inputs
            else None)
        self._prefix_ids_memo: Dict[str, tuple] = {}
        self.batcher = Batcher(self.buckets)
        self.stats = EngineStats()
        self.stats.backend = self.backend
        self.sampling = sampling or SamplingConfig()
        self._rid = 0
        self._block_size = bs if self._paged else 0
        self._alloc = BlockTableAllocator(slots, max_len // bs) if self._paged else None
        if self._paged and self.prefix_cache is not None:
            self.prefix_cache.add_evict_listener(self._on_prefix_evict)
        self._tables_dev = None
        self._tables_dirty = True
        self._active: Dict[int, Request] = {}           # slot -> request
        self._leaders: Dict[tuple, Request] = {}        # in-flight dedup
        self._followers: Dict[tuple, List[Request]] = {}
        self._cur_tok = np.zeros((self.slots,), np.int32)
        self._cur_pos = np.zeros((self.slots,), np.int32)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.sampling.seed)
        self._slot_state = None
        self._data_split = 1
        if mesh is not None:
            self._init_slots()

    # -- device steps ---------------------------------------------------
    def _prefill(self, toks, lens=None):
        n = toks.shape[0]
        batch = {"tokens": toks, **{k: v.expand(n, *v.shape)
                                    for k, v in self.extra_inputs.items()}}
        return api.prefill(self.params, self.cfg, batch,
                           max_len=self.max_len, compact_local=False,
                           lengths=lens, cap_tokens=toks.shape[1])

    def _prefill_from(self, prefix_state, toks, plen, lens=None):
        return api.prefill_from(self.params, self.cfg, prefix_state, toks, plen,
                                max_len=self.max_len, lengths=lens,
                                cap_tokens=toks.shape[1])

    def _insert(self, rows, slot_idxs, write_ids):
        if not self._paged:
            return api.insert_rows(self.cfg, self._slot_state, rows, slot_idxs)
        return api.paged_insert(self.cfg, self._slot_state, rows, slot_idxs,
                                write_ids, block_size=self._block_size)

    def _seed(self, entry_state, write_ids):
        return api.paged_seed(self.cfg, self._slot_state, entry_state,
                              write_ids, block_size=self._block_size)

    def _decode(self, tables, toks, pos):
        if self._paged:
            logits, state = api.paged_decode_step(
                self.params, self.cfg, self._slot_state, tables, toks[:, None], pos,
                block_size=self._block_size, max_len=self.max_len)
        else:
            logits, state = api.decode_step(self.params, self.cfg, self._slot_state,
                                            toks[:, None], pos, max_len=self.max_len)
        last = logits[:, -1]
        nxt = sample(last, self._gen, temperature=self.sampling.temperature,
                     top_k=self.sampling.top_k)
        return nxt, token_confidence(last, nxt), state

    def _init_slots(self):
        if not self._paged:
            self._slot_state = api.init_cache(self.cfg, self.slots, self.max_len,
                                              compact_local=False, device=self.device)
            if self.mesh is not None:
                self._slot_state = SC.place_slot_state(self._slot_state, self.cfg, self.mesh)
                self._data_split = SC.data_split(self._slot_state)
            return
        self._slot_state = api.init_paged_cache(
            self.cfg, self.slots, self._alloc.num_blocks, self._block_size,
            device=self.device)

    def _dev(self, a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- paged block-table plumbing -------------------------------------
    def _tables(self):
        """Device mirror of the allocator's block tables, refreshed only
        when host-side bookkeeping changed since the last decode."""
        if self._tables_dirty or self._tables_dev is None:
            self._tables_dev = self._dev(self._alloc.tables, torch.int32)
            self._tables_dirty = False
        return self._tables_dev

    def _on_prefix_evict(self, key, entry) -> None:
        self._alloc.drop_prefix(key)

    def _release_slot(self, s: int) -> None:
        if self._paged:
            self._alloc.release(s)
            self._tables_dirty = True

    def _paged_admit_ids(self, slot_idxs, pk, plen, entry):
        """Block-table bookkeeping for one admission wave.

        Seeds the prefix's FULL blocks into shared storage on first
        sight (partial tail blocks stay private), points every admitted
        row's table at the shared prefix + its private remainder, and
        returns the [n, nblk] write-id matrix for the KV scatter, with
        aliased chunks aimed at the trash block."""
        A = self._alloc
        shared = None
        if pk is not None:
            n_full = plen // self._block_size
            shared = A.lookup(pk)
            if shared is None and n_full:
                shared = A.seed_blocks(pk, n_full)
                if shared is not None:
                    w = np.full((1, A.nblk), A.trash, np.int32)
                    w[0, :n_full] = shared
                    self._seed(entry.state, self._dev(w))
        w_ids = np.empty((len(slot_idxs), A.nblk), np.int32)
        for i, s in enumerate(slot_idxs):
            s = int(s)
            w_ids[i] = A.private(s)
            if shared is not None and len(shared):
                A.alias(s, pk)
                w_ids[i, :len(shared)] = A.trash
            else:
                A.occupy(s)
        self._tables_dirty = True
        return w_ids

    # -- async API ------------------------------------------------------
    def _encode_prefix(self, prefix: str):
        hit = self._prefix_ids_memo.get(prefix)
        if hit is None:
            p_ids = self.tok.encode(prefix, bos=True)
            hit = (p_ids, self.prefix_cache.key(
                p_ids, self.version + self._placement_tag))
            self._prefix_ids_memo[prefix] = hit
        return hit

    def _split_prefix(self, text: str, prefix: Optional[str]):
        """(prefix_ids, suffix_ids, prefix_key) when the shared-template
        split is usable, else (None, full_ids, None); refused whenever the
        full prompt would be clipped to the top bucket or the stacked
        prefix+suffix bucket leaves no decode slot below max_len."""
        if (prefix is not None and self.prefix_cache is not None
                and len(text) > len(prefix) and text.startswith(prefix)):
            p_ids, pkey = self._encode_prefix(prefix)
            s_ids = self.tok.encode(text[len(prefix):]) + [self.tok.SEP]
            if len(p_ids) + len(s_ids) <= self.buckets[-1] \
                    and len(p_ids) + bucket_len(len(s_ids), self.buckets) \
                    <= self.max_len - 1:
                return p_ids, s_ids, pkey
            return None, p_ids + s_ids, None
        return None, self.tok.encode(text, bos=True) + [self.tok.SEP], None

    def submit(self, text: str, *, max_new: int = 32,
               prefix: Optional[str] = None) -> Request:
        """Enqueue one request; resolves immediately on a cache hit and
        attaches as a follower when its prompt is already in flight."""
        prefix_ids, ids, pkey = self._split_prefix(text, prefix)
        req = Request(rid=self._rid, prompt_ids=ids, max_new=max_new, src=text)
        if prefix_ids is not None:
            req.prefix_ids = prefix_ids
            req.prefix_key = pkey
        self._rid += 1
        if self.result_cache is not None:
            req.cache_key = self.result_cache.key(text, max_new, self.version)
            hit = self.result_cache.peek(req.cache_key)
            if hit is not None:
                text, conf = hit
                self.result_cache.record_hit(req.cache_key)
                self.stats.cache_hits += 1
                req.out_ids = self.tok.encode(text)
                req.confidence = conf
                self._finalize(req, text)
                return req
            if req.cache_key in self._leaders:
                self.result_cache.record_hit(req.cache_key)
                self.stats.cache_hits += 1
                req.follower = True
                self._followers.setdefault(req.cache_key, []).append(req)
                req.prompt_ids = []
                return req
            self.result_cache.record_miss()
            self._leaders[req.cache_key] = req
        self.batcher.add(req)
        inflight = len(self.batcher) + len(self._active)
        self.stats.peak_inflight = max(self.stats.peak_inflight, inflight)
        return req

    def step(self) -> List[Request]:
        return self.step_finish(self.step_begin())

    def step_begin(self) -> StepPending:
        """Admit a batch and enqueue the tick's decode without waiting for
        it.  Pair each call with exactly one ``step_finish``."""
        with kernel_backend(self.backend), torch.no_grad():
            return self._step_begin()

    def _step_begin(self) -> StepPending:
        if self._slot_state is None:
            self._init_slots()
        finished: List[Request] = []
        free = [s for s in range(self.slots) if s not in self._active]
        if free and len(self.batcher):
            take = self.batcher.take(len(free))
            if take:
                finished.extend(self._admit(take, free))
        if not self._active:
            return StepPending(finished, None)
        tables = None
        if self._paged:
            used, sh = self._alloc.stats()
            self.stats.kv_blocks_in_use = max(self.stats.kv_blocks_in_use, used)
            self.stats.kv_blocks_shared = max(self.stats.kv_blocks_shared, sh)
            tables = self._tables()
        nxt, conf, self._slot_state = self._decode(
            tables, self._dev(self._cur_tok), self._dev(self._cur_pos))
        self.stats.decode_steps += 1
        self.stats.busy_slot_steps += len(self._active)
        self.stats.total_slot_steps += self.slots
        return StepPending(finished, (nxt, conf))

    def _admit(self, take: List[Request], free: List[int]) -> List[Request]:
        """One bucketed prefill + one batched KV insert for ``take``."""
        finished: List[Request] = []
        top = self.buckets[-1]
        for r in take:
            if len(r.prompt_ids) > top:
                r.truncated = True
                self.stats.truncated += 1
        b = bucket_len(max(len(r.prompt_ids) for r in take), self.buckets)
        toks = np.zeros((len(take), b), np.int64)
        for i, r in enumerate(take):
            ids = r.prompt_ids[-b:]
            toks[i, :len(ids)] = ids
        lens = np.array([min(len(r.prompt_ids), b) for r in take])
        pk = take[0].prefix_key     # uniform across the batch
        if pk is not None:
            entry = self.prefix_cache.get(pk)
            fresh = entry is None
            if fresh:
                entry = self._build_prefix_entry(pk, take[0].prefix_ids)
            plen = entry.prefix_len
            logits, rows = self._prefill_from(entry.state, self._dev(toks), plen,
                                              self._dev(lens))
            seeded = len(take) - (1 if fresh else 0)
            entry.hits += seeded
            self.stats.prefix_hits += seeded
            self.stats.prefill_tokens_saved += plen * seeded
        else:
            plen, entry = 0, None
            logits, rows = self._prefill(self._dev(toks), self._dev(lens))
        self.stats.prefills += 1
        self.stats.prefill_tokens += len(take) * b
        # rows are right-padded: each row's logits at its last REAL position
        # (after a vlm's image positions)
        last = logits[torch.arange(len(take), device=self.device),
                      self._dev(self._n_img + lens - 1)]
        first_dev = sample(last, self._gen,
                           temperature=self.sampling.temperature,
                           top_k=self.sampling.top_k)
        first_conf = token_confidence(last, first_dev).double().cpu().numpy()
        first = first_dev.cpu().numpy()
        slot_idxs = np.asarray(free[:len(take)], np.int32)
        w_ids = (self._paged_admit_ids(slot_idxs, pk, plen, entry) if self._paged
                 else None)
        # each data position's rows of a mesh engine's slot state, as tensors
        # (a sequence split's pieces take every row, each its positions)
        idx = (SC.split_rows(slot_idxs, self.slots, self._data_split, self._dev)
               if self._data_split > 1 else self._dev(slot_idxs))
        self._slot_state = self._insert(rows, idx,
                                        None if w_ids is None else self._dev(w_ids))
        for i, r in enumerate(take):
            s = int(slot_idxs[i])
            t0 = int(first[i])
            r.out_ids.append(t0)
            r.confidence = min(r.confidence, float(first_conf[i]))
            if t0 == self.tok.EOS or len(r.out_ids) >= r.max_new:
                self._release_slot(s)
                finished.extend(self._retire(r))
                continue
            self._active[s] = r
            self._cur_tok[s] = t0
            self._cur_pos[s] = plen + self._n_img + int(lens[i])
        return finished

    def step_finish(self, pending: StepPending) -> List[Request]:
        """Wait for the launched decode, then retire/advance every active
        slot.  Returns all requests that finished during the tick."""
        finished, nxt = pending
        if nxt is None:
            return finished
        nxt, conf = nxt
        nxt = nxt.cpu().numpy()
        conf = conf.cpu().numpy()
        for s in list(self._active):
            r = self._active[s]
            t = int(nxt[s])
            r.out_ids.append(t)
            r.confidence = min(r.confidence, float(conf[s]))
            self._cur_tok[s] = t
            self._cur_pos[s] += 1
            if t == self.tok.EOS or len(r.out_ids) >= r.max_new \
                    or self._cur_pos[s] >= self.max_len - 1:
                del self._active[s]
                self._release_slot(s)
                finished.extend(self._retire(r))
        return finished

    def has_work(self) -> bool:
        return bool(len(self.batcher) or self._active)

    def drain(self) -> List[Request]:
        finished: List[Request] = []
        while self.has_work():
            finished.extend(self.step())
        return finished

    # -- introspection --------------------------------------------------
    def position_bytes(self, i: int) -> int:
        """Bytes mesh position ``i`` holds of a mesh engine's params
        (``compressed.position_bytes``) and slot state
        (``sharded_cache.state_position_bytes``)."""
        return position_bytes(self.params, i) + SC.state_position_bytes(self._slot_state, i)

    def jit_targets(self) -> Dict[str, object]:
        """Every step method on the tick hot path, by the reference's
        stable names: the surface the hot-path auditor
        (``analysis/jit_audit.py``) wraps.  The port has one ``_prefill``
        and one ``_prefill_from`` for every bucket; they are named
        ``[bucket]`` for each bucket of the ladder, as the reference's
        per-bucket jits are."""
        out: Dict[str, object] = {"_insert": self._insert, "_decode": self._decode}
        if self._paged:
            out["_seed"] = self._seed
        for b in self.buckets:
            out[f"_prefill[{b}]"] = self._prefill
        if self.prefix_cache is not None:
            for b in self.buckets:
                out[f"_prefill_from[{b}]"] = self._prefill_from
        return out

    # -- prefix sharing -------------------------------------------------
    def _build_prefix_entry(self, key, prefix_ids):
        """One-time prefill of a template prefix (batch 1, absolute
        slots); the stored state seeds every row that shares it."""
        toks = self._dev(np.asarray(prefix_ids)[None])
        _, cache = self._prefill(toks, self._dev([len(prefix_ids)]))
        self.stats.prefills += 1
        self.stats.prefill_tokens += len(prefix_ids)
        return self.prefix_cache.put(key, cache, len(prefix_ids))

    # -- completion plumbing -------------------------------------------
    def _retire(self, req: Request) -> List[Request]:
        text = self.tok.decode([t for t in req.out_ids if t != self.tok.EOS])
        done = [req]
        if self.result_cache is not None and req.cache_key is not None:
            self.result_cache.put(req.cache_key, (text, req.confidence))
            self._leaders.pop(req.cache_key, None)
            for f in self._followers.pop(req.cache_key, []):
                f.out_ids = list(req.out_ids)
                f.confidence = req.confidence
                self._finalize(f, text)
                done.append(f)
        self._finalize(req, text)
        return done

    def _finalize(self, req: Request, text: str) -> None:
        req.text = text
        req.done = True
        req.prompt_ids = []
        self.stats.rows += 1
        self.stats.tokens_out += len(req.out_ids)
        if np.isfinite(req.confidence):
            self.stats.confidence_sum += req.confidence
            self.stats.confidence_rows += 1

    # -- synchronous convenience wrappers ------------------------------
    def generate(self, texts: Sequence[str], *, max_new: int = 32,
                 prefix: Optional[str] = None, return_requests: bool = False):
        """Continuous-batching run over all texts; returns decoded rows
        (or, with ``return_requests``, the finished ``Request`` objects,
        whose ``out_ids`` hold the emitted token ids)."""
        t0 = time.time()
        reqs = [self.submit(t, max_new=max_new, prefix=prefix) for t in texts]
        self.drain()
        self.stats.wall_s += time.time() - t0
        if return_requests:
            return reqs
        return [r.text for r in reqs]

    def generate_stream(self, prompts, *, max_new: int = 32,
                        chunk: int = DEFAULT_CHUNK,
                        prefix: Optional[str] = None,
                        return_requests: bool = False):
        """Consume ``prompts`` lazily, keeping at most ``chunk`` of this
        call's requests un-finished at a time; returns decoded rows in
        prompt order (or the finished ``Request`` objects)."""
        t0 = time.time()
        reqs: List[Request] = []
        inflight = set()
        for p in prompts:
            r = self.submit(p, max_new=max_new, prefix=prefix)
            reqs.append(r)
            if not r.done and not r.follower:
                inflight.add(r.rid)
            while len(inflight) >= max(1, chunk):
                for f in self.step():
                    inflight.discard(f.rid)
        self.drain()
        self.stats.wall_s += time.time() - t0
        if return_requests:
            return reqs
        return [r.text for r in reqs]
