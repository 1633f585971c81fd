#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero).
The nvcc runs of phase 1 start first and compile while phases 51 and 52,
which launch no kernel, train on the card; every CPU reference of the
training parities (phases 13 and 51) and of the compressed all-reduce
(phase 54), and phase 54's checkpoint round trip, run on a worker
thread (``Background``) while the card's phases go on, and their checks
fail the run when it is joined; phases 15, 16 and 55 (``tiny-olap``) run
in a second process (``tiny_phases``) from after ``multi_pod_engine``
to before phase 17:

1. card: prints the card's name and power limit and the host's CPUs, builds the four CUDA
   kernels of ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
   parallel) and counts the tensor-core instructions (HGMMA, HMMA) in
   each library's machine code and the bytes ptxas spills: every library
   must have tensor-core instructions (K1's in its ``mma`` design), K1 and
   K2 no spill;
2. kernels: calls each kernel's wrapper at the main paths' shapes and at
   edge cases, holds it against its plain PyTorch version, and times
   kernel, plain version and a library call (CUDA events, L2 flushed
   before every launch): K2 quant_matmul (decode M = 8 and prefill
   M = 512, each also on the FMA design it replaced), K1 paged_attention
   (128 and 1024 positions a slot), K4 block_sparse_matmul (decode M = 8
   and prefill M = 512), K3 flash_attention (S = T = 4096 and 8192); each
   line carries bound_share = bound_ms / ms;
3. main path: full-width gemma2-2b (26 layers, random bf16 weights from a
   seeded generator) compressed with the ``w8-absmax`` recipe, served by
   ``Engine(slots=8, max_len=1024)`` on OLAP-style rows sharing one
   template (one duplicate row), then the bf16 base model the same way;
   the kernels' launch counts are zeroed just before the int8 run and
   read just after (182 K2 launches per decode step on ``decode`` and per
   prefill on ``mma``, 26 K1 launches per step on ``split``);
4. whole step: one paged decode step of the int8 instance under the cuda
   backend and under the reference backend on the same state, in bf16 and
   in f32; the launch counts show that only the cuda side ran the kernels;
   then a profile of the step;
5. block_sparse: the base calibrated on 16 of the rows (activation norms),
   compressed with ``bs16@75`` (every linear block-sparse) and served the
   same way, the counts zeroed just before the run and read just after
   (182 K4 launches per decode step and per prefill, no K2, all on the
   bf16 tensor-core designs: ``decode`` in the steps, ``mma`` in the
   prefills); then the whole-step check and the profile on this instance;
6. long_prefill: ``prefill(use_flash=True)`` of a 4096-token document
   (26 K3 launches on the cuda side), and an 8192-token prefill through
   ``best_attention`` (13 K3 launches, the global layers), each under the
   cuda and the reference backends (no K3 launch), in bf16 and f32, held
   to the whole-step criteria;
7. olap_session: the main path of a query.  An ``IOLMSession`` over the
   bf16 base (its first 8 layers, ``SESSION_LAYERS``) runs the queries of ``examples/olap_queries.py`` (Q1
   ``llm_map`` over 64 reviews, Q2 ``llm_correct`` over 64 values, Q3
   ``llm_join`` of 16 x 16 names, Q4 ``llm_correct`` + a pushed-down
   filter with dedup, EXPLAINed first) and Q5, Q2 as a forced cascade
   with budget 0.25, through ``Query.run``: each LLM operator calibrates
   on its own rows, searches ``w8-absmax`` and absmax copies of the
   grid's ``w8-ffn75`` and ``w8-kv50`` (every candidate built and
   evaluated, the pruned configs checked) and serves the picked instance
   through ``Engine``; the grid's GPTQ ``w8-ffn75`` is applied once on
   Q1's statistics and timed.  Rows, columns, invocations, model-cache
   hits, ``backend=cuda`` in EXPLAIN, and every engine's K1 and K2
   launches (from ``ops.variant_count``) are checked per query;
8. olap_f32_parity: Q2 at gemma2-2b's widths in f32 at 4 layers under a
   cuda-backend session and a reference-backend session: identical
   tables, and any prompt whose tokens differ must be a near tie;
9. olap_pool_fleet (phases 9, 10 and 12 run gemma2-2b cut to its first
   POOL_LAYERS = 8 layers, the same weights at the published widths, to
   keep the script within its time): several tenants, each with its own
   data-correction
   template (so its own instance), through one byte-budgeted
   ``ModelPool`` and one fair-share ``Scheduler`` under a budget of 2.8
   base entries: a ``base`` fleet (identity recipe) and an ``iolm`` fleet
   (``w8-absmax``) at 1 and 4 tenants, the instances built first, then
   one timed pass through a new pool; rows per second, residency, the pool's bytes beside ``memory_allocated``,
   evictions and per-tenant latency quantiles; every row returned, the
   budget never exceeded, more resident ``iolm`` than ``base`` models at
   4 tenants, each tenant's rows equal to a private serial engine's (bf16
   rows parted at a near tie counted), K1 and K2 launched, no
   degradation;
10. olap_pool_session: phase 7's Q1-Q5 as five tenants of one pooled
   session through ``Scheduler.run_queries``, against the same queries
   run serially on the same built models: every table row equal, in
   order, but those of prompts parted at a near tie or escalated in one
   run only (counted), wrong rows put in place of right ones not passing
   as near ties, Q5's escalations alike but where a row's confidence moved
   (counted), proxy and base resident together at the cascade fit,
   ``placement: pool`` in EXPLAIN, each build's peak memory and each
   engine's truncated prompts printed;
11. olap_pool_f32_parity: Q1 and Q2 in f32 at 4 layers as two tenants of
   a pooled cuda-backend session against a serial reference-backend
   session: identical tables (every differing row a near tie's, in
   order), launches on the cuda side only;
12. service_full_width (run before phase 11, while the base is in memory;
   full width, cut depth): the HTTP service over a pooled session with phase 7's
   pinned recipes answers Q2 as one tenant; its rows equal ``Query.run``
   on the same session, and its warm state (``POST /checkpoint`` under
   ``OUT_DIR``) restores in a fresh session with no build and the
   same rows; bytes on disk and save and restore seconds recorded;
13. train_parity: one AdamW ``make_train_step`` step at gemma2-2b's
   widths in f32 at 4 layers on the card and on the CPU from the same
   params and batch (loss, grad norm, updated params), and on the card
   remat on against off and two microbatches against one; a K3 call on
   inputs that require grad is refused (phase 51 runs the same for the
   other families);
14. train_full_width: five AdamW steps of gemma2-2b at all 26 layers in
   bf16 (batch 4 x 1024 tokens, two microbatches, remat, the unembed
   streamed in chunks of 256): loss and grad norm finite, step wall,
   tokens/s, peak memory and 6 N tokens over the step's bf16 peak;
15. train_tiny_olap: ``benchmarks/common.py``'s ``tiny-olap`` trained to
   its recipe (300 steps, checkpoints every 150 under ``OUT_DIR``):
   the loss falls below 0.7 of its first value, both restores equal the
   state in memory bit for bit, and a run over only step 150 resumes;
16. service_trained: the HTTP service over the trained ``tiny-olap``
   with the reference's nine-recipe grid answers Q1-Q4 as four tenants;
   rows equal ``Scheduler.run_queries`` on a fresh session sharing the
   model cache; after ``POST /checkpoint`` a new session restored warm
   answers with the same rows and no build; every candidate's accuracy
   and agreement, the picks and per-tenant latency recorded.  The
   training phases launch none of the four kernels; the two service
   phases launch K1 and K2 and neither K3 nor K4.
17. kernel_quant_matmul_experts (the MoE phases run last, from
   generators of their own, MOE_SEED and MOE_KERNEL_SEED): K2 over
   experts, every expert of a linear in one launch, against its plain
   version at qwen2-moe's expert shapes (E 60, 30, 15; C 8, 14, 32, 64,
   256, 512 and 1024; 2048 -> 1408 and back; ``in_scale``, f32, K 1056
   in groups of 96) and K1 at qwen2-moe's decode shape; one expert
   linear timed in a decode step;
18. moe_main_path: full-width qwen2-moe-a2.7b (24 layers, 60 experts
   top 4, 4 shared; random bf16 weights) compressed with ``w8-absmax``
   and served by ``Engine(slots=8, max_len=1024)`` on the main path's
   rows, then the bf16 base: per decode step 169 K2 launches on
   ``decode``, 72 of K2 over experts on ``expert_decode``, 24 of K1;
   per prefill 169 on ``mma`` and 72 on ``expert_mma``; the base K1 only;
19. moe_whole_step: one decode step of that int8 instance, cuda against
   reference backend, in bf16 at full width (STEP_BF16_RATIO; tokens
   whose expert sets differ counted) and in f32 at 4 layers (STEP_TOL_F32,
   identical routes); then moe_decode_profile, the step's profile;
20. moe_session: an ``IOLMSession`` over the base's first 4 layers runs Q2 and
   Q1 (64 rows each) with ``w8-absmax`` and absmax copies of
   ``w8-expert50`` and ``w8-expert25``: no Hessian calibrated, each
   router's counts summing to calibration tokens x top_k, the pruned
   candidates (30 and 15 experts) keeping the most-routed experts,
   ``backend=cuda`` in EXPLAIN, the served engine on K1, K2 and K2 over
   experts;
21. kernel_quant_matmul_experts_seen: K2 over experts against its plain
   version at every shape phases 18 and 20 gave it (``ExpertShapeProbe``
   records them), on the design each ran; one expert linear timed at
   the main path's most frequent prefill shape;
22. moe_f32_parity: Q2 at qwen2-moe's widths in f32 at 4 layers, cuda
   against reference session (phase 8's criteria).
23. kernel_paged_attention_d112 and kernel_flash_attention_d112 (the
   hybrid phases run last, from generators of their own, HYBRID_SEED and
   HYBRID_KERNEL_SEED): K1 at zamba2's head dim 112 (8 slots, 32 and 16
   KV heads of one query head, blocks of 32, 128 and 1024 positions,
   ragged lengths, aliased tables) and K3 at 112 (S = T = 8192, H = Kh =
   32, a ragged ``t_real``, tile edges), bf16 and f32, against their plain
   versions, and timed;
24. hybrid_main_path: full-width zamba2-7b (70 Mamba2 layers and 11 sites
   of one shared attention block, 5.89 B params; random bf16 weights)
   compressed with ``w8-absmax`` and served by ``Engine(slots=8,
   max_len=1024)`` on the main path's rows, then the bf16 base: per
   decode step 218 K2 launches on ``decode`` and 11 of K1, per prefill
   218 on ``mma``; the template prefix's length and seconds recorded;
25. hybrid_whole_step: one decode step of that instance, cuda against
   reference backend, bf16 at full depth (STEP_BF16_RATIO) and f32 cut to
   15 block applications (2 sites, 2 groups of 6, 1 tail layer;
   STEP_TOL_F32);
26. hybrid_contiguous: the same rows through ``kv_layout="contiguous"``
   (no K1): bf16 rows equal to the paged run's or parted at a near tie;
   in f32 at 15 block applications, and on gemma2-2b cut to 4 layers,
   identical tokens; then hybrid_decode_profile, the step's profile;
27. hybrid_long_prefill: one 8192-token prompt through the hybrid's
   ``prefill`` (K3 at each of the 11 sites), bf16 and f32, cuda against
   reference backend, seconds and peak memory;
28. hybrid_session: Q2 and Q1 at 64 rows through ``Query.run`` over a
   zamba2 session on the base's first 2 groups (14 block applications)
   with ``w8-absmax`` and absmax copies of ``w8-ffn75`` and ``w8-kv50``
   (no Hessian; the shared block's statistics summed over its 2 sites);
   K1 and K2 on the served engines;
29. kernel_quant_matmul_seen: K2 against its plain version at every shape
   phases 24 (its int8 run) and 28 gave it (``QuantShapeProbe`` records
   them), ``decode`` and ``mma`` alike, on the design each ran; zamba2's
   in_proj (3584 -> 14576) timed at decode M = 8 and at the main path's
   most frequent prefill M;
30. hybrid_f32_parity: Q2 in f32 at 15 block applications, cuda against
   reference session (phase 8's criteria).
31. rwkv_main_path (the rwkv phases run last, from generators of their own,
   RWKV_SEED and RWKV_KERNEL_SEED): full-width rwkv6-3b (32 layers, d_model
   2560, 40 heads of 64, d_ff 8960, vocab 65536; 3.07 B params, random bf16
   weights) compressed with ``w8-absmax`` and served by ``Engine(slots=8,
   max_len=1024)`` on the main path's rows and template, then the bf16
   base: the contiguous layout (slot state 8 x 21.6 MB), every row seeded
   from the template's recurrent state; per decode step 257 K2 launches on
   ``decode``, per prefill 257 on ``mma``, K1, K3 and K4 never;
32. rwkv_whole_step: one contiguous decode step of that instance, cuda
   against reference backend, bf16 at 32 layers (STEP_BF16_RATIO) and f32
   cut to 4 (STEP_TOL_F32); then rwkv_decode_profile, the step's profile;
33. rwkv_session: Q2 and Q1 at 64 rows through ``Query.run`` over a
   rwkv6-3b session on the base's first 8 layers (``SESSION_LAYERS``) with
   ``w8-absmax`` and ``w8a-ffn75`` (the grid has no ``w8-kv50`` for rwkv;
   no Hessian): the pruned candidate at d_ff 6720, its ``cm.wv`` in groups
   of 120 on K2's ``fma`` design, one launch a layer of each call;
34. kernel_quant_matmul_rwkv: K2 against its plain version at every shape
   phases 31 (its int8 run) and 33 gave it, group 120 included; the pruned
   ``cm.wv`` (6720 -> 2560, group 120, ``fma``) and the unpruned one (8960
   -> 2560, group 128) timed at M = 8 and 512;
35. rwkv_f32_parity: Q2 in f32 at 4 layers, cuda against reference session
   (phase 8's criteria; K2 alone on the cuda side).
36. vlm_main_path (the vlm and encdec phases run last, from generators of
   their own, VLM_SEED, ENCDEC_SEED and VLM_ENCDEC_KERNEL_SEED): full-width
   paligemma-3b (18 layers, d_model 2048, 8 query heads on 1 KV head of
   256, d_ff 16384, vocab 257216, tied; 2,508,662,784 params, random bf16
   weights) compressed with ``w8-absmax`` and served by ``Engine(slots=8,
   max_len=1024, extra_inputs={"img_embs": ...})``, a seeded [256, 2048]
   image ahead of every row, then the bf16 base: the contiguous layout, no
   prefix cache; 126 K2 launches a model call (``decode`` in the steps,
   ``mma`` in the prefills), K1, K3 and K4 never;
37. vlm_whole_step: one contiguous decode step of that instance at 18
   layers in bf16, cuda against reference backend (STEP_BF16_RATIO); then
   vlm_decode_profile, the step's profile;
38. vlm_session: Q2 and Q1 at 64 rows, text only, through ``Query.run``
   over a paligemma session on the base's first 6 layers with ``w8-absmax`` and
   ``w8a-ffn75`` (no ``w8-kv50`` for one KV head; no Hessian);
39. vlm_f32_parity: paligemma's widths in f32 at 4 layers with a seeded
   image: the engine's rows under both backends and ``forward``'s greedy
   tokens on the image-prefixed sequences identical, or parted at a near
   tie;
40. encdec_main_path: full-width whisper-base (6 + 6 layers, d_model 512, 8
   heads of 64, d_ff 2048, vocab 51865; 164,291,584 params, random bf16
   weights) compressed with ``w8-absmax`` and served by ``Engine(slots=8,
   max_len=512, extra_inputs={"enc_inputs": ...})``, 1500 seeded frames
   for every row, then the bf16 base: per decode step 48 K2 launches on
   ``decode`` and the untied unembed's (N 51865) on ``fma``, per prefill
   96 on ``mma`` and the unembed's on ``fma``; then
   encdec_decode_profile, the step's profile;
41. encdec_build: calibration on 16 of the rows with their frames, then
   ``w8-absmax``, ``w8a-ffn75`` and ``w8a-kv50`` built and served, their
   seconds, designs and agreement with the base recorded (the session
   passes no ``enc_inputs``, so ``Query.run`` over encdec raises);
42. encdec_f32_parity: whisper-base at full width in f32, rows identical
   across backends, or parted at a near tie;
43. kernel_quant_matmul_vlm_encdec: K2 against its plain version at every
   shape phases 36, 38, 40 and 41 gave it, whisper's unembed on ``fma``
   included; paligemma's ``wi`` and whisper's unembed timed at M = 8 and
   512.
44. kernel_paged_attention_g48 and kernel_flash_attention_g48 (the granite
   phases run last, from generators of their own, GRANITE_SEED and
   GRANITE_KERNEL_SEED): K1 at granite's MQA (8 slots, one KV head, D 128,
   blocks of 32) at G 48 and at G 9, 16 and 24 around the 8-row boundary,
   lengths 1 to 1024 around the split edges, plain and aliased tables, bf16
   (``mma``) and f32 (``chunked``), a window and a softcap, bf16 at G 72
   (``chunked``); at G 8 ``mma`` and ``chunked`` beside ``split`` on the
   same inputs; timed at 128 and 1024 positions.  K3 at granite's layout
   (S = T = 4096, H 48, Kh 1, D 128, tile edges), bf16 and f32, timed;
45. granite_main_path: full-width granite-20b (52 layers, d_model 6144, 48
   query heads on one KV head of 128, an ungated GELU MLP of 24576, vocab
   49152, untied; 20,315,111,424 params, random bf16 weights) compressed
   with ``w8-absmax`` and served by ``Engine(slots=8, max_len=1024)``
   (paged), then the bf16 base: per decode step 313 K2 launches on
   ``decode`` and 52 of K1 on its ``mma`` design, per prefill 313 on
   ``mma``; no K3 or K4; params, bytes of both versions and peak memory;
46. granite_whole_step: one decode step of that instance at 52 layers, cuda
   against reference backend (STEP_TOL_F32 in f32, where K1 runs
   ``chunked``; STEP_BF16_RATIO in bf16); then granite_decode_profile, the
   step's profile beside its byte floor;
47. granite_session: Q2 at 64 rows through ``Query.run`` over a copy of
   granite's first 26 layers (GRANITE_SESSION_LAYERS: at 52 the ffn75
   candidate's pruned bf16 weights beside the base and the kept
   ``w8-absmax`` candidate outgrow the card) with ``w8-absmax`` and
   ``w8a-ffn75`` (d_ff 18432; no ``w8-kv50`` for one KV head; no Hessian);
48. kernel_quant_matmul_granite: K2 against its plain version at every
   shape phases 45 (its int8 run) and 47 gave it; granite's ``wi`` and
   untied unembed timed at M = 8 and 512;
49. granite_f32_parity: Q2 in f32 at 4 layers, cuda against reference
   session (phase 8's criteria; K1 on ``chunked`` on the cuda side).
50. qembed_serve (run after phase 4, while the base is in memory):
   ``w8-absmax`` and ``w8-absmax`` with ``quant_embed=True`` built from the
   full-width base, each served on phase 3's paged engine: the ``QEmbed``
   instance (gemma2-2b's tied 256000 x 2304 table as int8 codes and f32
   row scales) saves exactly 588,800,000 bytes more, its run launches K1
   and K2 as phase 3's int8 run does, its rows equal the ``w8-absmax``
   rows but where they part at a near tie (``tie_at``, sigma from the
   ``QEmbed`` instance's bf16 path; a control row must not pass); the
   tied product and ``QEmbed.logits`` at M = 8 hold the f32 product of
   their bf16 operands to TIED_RTOL (rounding through bf16 misses it by
   two orders of magnitude), and both are timed at M = 8 and 512;
51. train_family_parity (the training phases run first, beside the
   build, from TRAIN_FAMILY_SEED): phase 13 for zamba2-7b at one group of its layout
   (Adafactor), rwkv6-3b at 2 layers and qwen2-moe-a2.7b at 1 layer
   (AdamW), each at its published widths in f32; the MoE's two
   microbatches are held against two on the CPU (its loss does not split
   over rows);
52. train_full_width_<family>: three bf16 steps at the published widths,
   remat on, batch 4 in two microbatches: zamba2-7b at all 81 layers
   with Adafactor, rwkv6-3b (32 layers), paligemma-3b with seeded
   ``img_embs`` (the loss on the text positions), whisper-base with
   seeded encoder frames and 448-token targets, and qwen2-moe-a2.7b at
   its first 4 of 24 layers (57.3 GB of bf16 params and grads at full
   depth), the last four with AdamW: phase 14's record and checks.
53. static_analysis (run after phase 4, on phase 3's int8 engine) and
   static_analysis_rwkv (after phase 32, on phase 31's): the hot-path
   audit (``analysis/jit_audit.py``) of full-width gemma2-2b's paged
   ``w8-absmax`` engine and rwkv6-3b's contiguous one under
   ``set_sync_debug_mode("warn")``: every step method's calls and
   signatures, the diagnostics by code, the decode step's measured FLOPs
   and bytes against 2 N_active slots and params + 2 x slot state, K1 and
   K2 launched during the audit (K2 alone on rwkv), and the step's
   analytic bound (``launch/roofline.py``) beside the phase's profile;
   the engine's targets restored, no diagnostic outside
   ``tools/torch_analysis_baseline.json``, no slot-state copy (JIT002),
   the analytic bytes within 5% of PERF.md's byte floors.
54. tensor-parallel serving, every mesh position on this card (from
   TP_SEED): tp_main_path (after static_analysis): phase 3's int8
   instance behind ``Engine(mesh=)`` at (1, 4), 16 rows of 16 tokens,
   against the unsharded contiguous engine; K2 at the rule table's count
   (728 a decode step and a prefill, 182 unsharded) on ``decode``/``mma``
   only, nothing else; the first decode step, over the slot state placed
   as the engine places it, within STEP_BF16_RATIO of the plain step's
   error against f32; parted rows near ties (``tie_at``);
   each position's bytes; both steps profiled;
   tp_kernel_shapes: K2 against its plain version at every piece shape
   launched, each (K, N) timed at M = 8 and the prefill's M; tp_pool
   (after service_full_width): ``ModelPool(mesh=)`` admits the 8-layer
   ``w8-absmax`` instance sharded beside two placed tenants, rows equal to
   private engines of the same placement run serially;
   parallel_training: ``pipeline_forward`` over 2 stages of 4 full-width
   layers in f32 against the sequential forward; a train step of a placed
   tree against the same step unsharded on the card (``sharded_step_check``:
   (a) those 4 layers in f32 at (2, 2) with FSDP, AdamW, its rows split
   over "data", at the CPU gate's tolerances, its executed collectives
   equal to ``roofline.train_collectives`` by kind, bytes and calls; (b)
   zamba2-7b at one group in f32 at (1, 4), Adafactor, at train_parity's, and the unsharded optimizer on its own gradients at the
   CPU gate's; both with each position's param and state bytes the
   specs'), ``compressed_allreduce`` over 2 "data" positions on (a)'s
   sharded gradients (the tied table's included) against the CPU's, and
   (c) ``sharded_full_width``: 2 bf16 AdamW steps of all 26 layers at
   (1, 4), (d) the same 2 steps data-parallel at (2, 2) without FSDP
   (one row a "data" position, each step's collectives equal to the
   count), then 2 unsharded (both placements' losses within
   SHARDED_BF16_RTOL), the (1, 4) params saved and restored unsharded bit
   for bit;
   tp_f32_parity: gemma2-2b, granite-20b and rwkv6-3b cut to 4 layers
   and zamba2-7b to one group in f32 at (1, 4) and (2, 2), tokens equal
   to the unsharded engine's or parted at a near tie, rwkv's ``S`` and
   mamba's ``h`` over heads; tp_moe (after moe_session): qwen2-moe cut to 4
   layers, ``w8-absmax`` at (2, 2), experts over "data", K2 over experts
   on every piece, the first step held as tp_main_path's.  The mesh
   engine's slot state follows ``cache_shardings`` (``models/
   sharded_cache.py``): tp_main_path and tp_f32_parity hold each
   position's slot-state bytes to the rule's share (109,051,904 B of the
   main path's 436,207,616 at (1, 4)) and one decode step's collectives
   to ``roofline.collective_bytes`` (the main path: 3 all-gathers a layer
   fewer than over an unsharded cache, the q/k/v gathers); tp_pool
   records what each position holds beside what the pool charges.
   tp_rwkv (after rwkv_session): rwkv6-3b's ``w8-absmax`` at its session
   depth behind ``Engine(mesh=)`` at (1, 4), ``S`` over heads, K2 at the
   rule table's count, the first step held as tp_main_path's, rows near
   ties where they part, the decode steps profiled;
   tp_rwkv_kernel_shapes: K2 at each piece shape it ran.
55. examples (after service_trained, on train_tiny_olap's checkpoint,
   kept for it): the five ``examples/torch_*.py`` ``main``s on the card
   at EXAMPLE_ROWS rows: quickstart (its three recipes' bytes equal the
   CPU's, K2 launched for ``w8-gptq``), train_lm (EXAMPLE_TRAIN_STEPS:
   a short run whose loss falls, then a resume that logs it), multi_tenant
   (K1 and K2 launched), serve_compressed (the full nine-recipe grid; K1)
   and olap_queries (the grid for each query; K1; Q4's invocations equal
   its distinct surviving values); every engine on the cuda backend.
56. long_decode (after the granite phases, from a generator of its own,
   LONG_DECODE_SEED): full-width gemma3-1b (26 layers ``"LLLLLG" * 4 +
   "LL"``, d_model 1152, 4/1 heads of 256, d_ff 6912, vocab 262144,
   window 512) at the reference's ``long_500k`` decode shape (one row,
   ``max_len`` 524,288): an 8192-token prompt through
   ``api.build_prefill_step(use_flash=True)`` (K3 on every layer) and 16
   steps through ``api.build_serve_step``, over the compact local-window
   cache and over the absolute one, each cache freed before the next; the
   f32 base's prefill logits identical bit for bit between the layouts,
   its greedy tokens identical and its steps' logits within
   LONG_DECODE_F32_TOL (the bf16 base's distance from them recorded
   beside); the ``w8-absmax`` instance's bf16 layouts
   (K2 on every linear) fed the tokens of its f32 copy, the compact one
   held to the absolute one (RMS within LONG_DECODE_BF16_LAYOUT_TOL, every
   greedy token the same) and to the whole-step rule; the bf16 caches'
   bytes equal 2,159,017,984 and 13,958,643,712; K2 and K3 launched as
   ``long_decode_launches`` says.
57. train_split_fallbacks (after parallel_training, on its full-width
   base): all 26 layers of gemma2-2b in bf16, AdamW, remat, ``xent_chunk``
   256, placed at (2, 2) without FSDP, every position this card, through
   the train step's two split fallbacks (``data_parallel.Split``): (a) one
   row of 2048 positions, its positions over "data" (1024 a piece, the
   K/V gathered at every layer); (b) 2 rows of 1024 in 2 microbatches, one
   row a microbatch over 2 dp positions (each runs it, as XLA places the
   reference's reshape).  Each step against the same step unsharded on
   the card: the loss within SHARDED_BF16_RTOL; the update element by
   element (AdamW's first step moves an element by lr whatever its
   gradient's size, so two bf16 computations of it agree where the
   gradients' directions do): where the clipped gradients agree in sign
   and are both at least SHARDED_GRAD_FLOOR, within lr / 50 and one bf16
   step of the param; elsewhere (near-zero gradients, as the CPU gate
   counts them, and directions that part) within 2 lr and one step, those
   elements counted, the parted directions at most SPLIT_PARTED_SHARE of
   any leaf's elements above the floor (the unsharded step's gradients
   kept in bf16 on the host); its executed collectives equal to
   ``roofline.train_collectives`` by kind, bytes and calls.  Records each
   step's seconds, peak memory and collective bytes.
58. train_position_split (after train_split_fallbacks): full-width
   paligemma-3b (18 layers, seeded image embeddings, 1024 text tokens)
   and full-width whisper-base (6 + 6 layers, 1500 seeded frames, 448
   tokens), each from POSITION_SPLIT_SEED, one bf16 AdamW step with remat
   of one row, unsharded and placed at (2, 2) without FSDP with the row's
   text positions over "data" (each piece its block of the text; the
   image, or the frames through the encoder, whole), under phase 57's
   gates and, over every element, fewer than SPLIT_FLIPPED_SHARE of the
   gradients above the floor flipped.  Records each step's seconds, peak
   memory and FLOP share.

K2, K3 and K4 run their tensor-core designs on bf16 and their FMA
designs on f32; K1 runs ``split`` up to 8 query heads per KV head in
either dtype and above that ``mma`` (bf16) or ``chunked`` (f32);
``ops.variant_count`` shows which design of every kernel ran, and every
phase checks it.
Prints one JSON line per phase and each phase's seconds and
``memory_allocated`` before and after it, the
``{"kernels": [...]}`` summary (with each kernel's launches on its own
path, over ``olap_session``, over the pooled runs of phases 9-11 and
over the two service phases, and
on the MoE path: ``launches_moe``, and K2's expert designs and timing;
on the hybrid path: ``launches_hybrid``, ``launches_hybrid_session``,
``launches_hybrid_long_prefill``, K1's and K3's ``d112`` timings, and
K2's ``hybrid`` cases seen and in_proj timings; on the rwkv path:
``launches_rwkv``, ``launches_rwkv_session``, and K2's ``rwkv`` cases seen
and channel-mix timings; on the vlm and encdec paths: ``launches_vlm``,
``launches_vlm_session``, ``launches_encdec``, ``launches_encdec_build``,
and K2's ``vlm_encdec`` cases seen and timings; on the granite path:
``launches_granite``, ``launches_granite_session``, K1's and K3's ``g48``
timings, and K2's ``granite`` cases seen and timings; on the
long-context decode: ``launches_long_decode``; on the QEmbed
instance's serve: ``launches_qembed``; during the audits:
``launches_static_analysis`` and ``launches_static_analysis_rwkv``; on
the sharded runs: ``launches_tp``, ``launches_tp_pool``,
``launches_tp_moe``, and K2's ``tp`` piece shapes and timings; over the
examples: ``launches_examples``),
the card line, and last ``{"ok": true, "device": {...}}``.  Exits non-zero
without a card and outside a checkout of the repository.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")      # the run's record (gitignored)
sys.path.insert(0, os.path.join(ROOT, "src"))

# the card's HBM rate and dense bf16 peak, and the least time for given bytes
# and operations: launch/roofline.py keeps them, with their source
from repro_torch.launch.roofline import BF16_FLOPS, HBM_BYTES_PER_S, bound  # noqa: E402,F401

K2_TOL = 2e-2                    # bf16 bound of tests/test_kernels.py
K1_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# K1 at granite's G, per slot (slot_errors) against the plain version's
# unrounded f32 output: a bf16 output is off by at most half an ulp of
# itself, 2^-8 = 3.9e-3 of the slot's largest value, plus f32 summation
# order; a skipped or mis-merged split moves a slot by 1e-1 or more of its
# scale (_k1_planted_faults)
K1_SLOT_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
# whole decode step, kernels vs plain path, as the RMS of the logit difference
# over the RMS logit.  In f32 the two differ only in summation order, so they
# must agree closely.  In bf16, through 26 layers of random weights, one bf16
# rounding that the two orders resolve differently grows layer by layer (the
# two bf16 steps differ by 5e-2 to 9e-2); there the kernels' step is held to
# the f32 step: no further from it than STEP_BF16_RATIO times the plain
# path's own bf16 step, summed over the trials.
STEP_TOL_F32 = 1e-3
STEP_BF16_RATIO = 1.25
# gemma2-2b's linears (K, N) in layer order: wq, wk, wv, attn wo, wi, wg, mlp wo
LAYER_SHAPES = [(2304, 2048), (2304, 1024), (2304, 1024), (2048, 2304),
                (2304, 9216), (2304, 9216), (9216, 2304)]
# the linears that the OLAP session's pruned recipes change: ffn75's wi, wg
# and mlp wo; kv50's wq, wk (and wv) and attn wo
PRUNED_SHAPES = [(2304, 6912), (6912, 2304), (2304, 1024), (2304, 512), (1024, 2304)]
# tiny-olap's linears (K, N) in the service's nine-recipe grid: wq and attn
# wo, wk and wv, wi and wg, mlp wo; ffn75's wi, wg and mlp wo (d_ff 288,
# groups of 96); the unembed (N 260, untied); kv50's wq, wk and wv, attn wo
# (1 KV group, 2 heads)
TINY_SHAPES = [(128, 128), (128, 64), (128, 384), (384, 128), (128, 288), (288, 128),
               (128, 260), (128, 32), (64, 128)]
TINY_M = (8, 384)                # a decode step of 8 slots; 8 rows of the 48 bucket
# tiny-olap's decode attention: 8 slots, 2 KV groups of 2 heads, head dim 32,
# the engine's block of 32 at max_len 160 (5 blocks a slot); no window or softcap
TINY_PA = {"Kh": 2, "G": 2, "D": 32, "bs": 32, "nblk": 5}
# the tiny-olap cases draw from a generator of their own, so that the shared
# generator, and with it every later phase's weights, is what it was without them
TINY_SEED = 17

TEMPLATE = "Classify the review's sentiment as pos or neg.\nReview: "
REVIEWS = [
    "Battery lasts two full days, very happy.",
    "Stopped charging after a week.",
    "Fits well but the strap feels cheap.",
    "Exactly as described, fast shipping.",
    "Screen scratched on arrival, refund requested.",
    "Great value for the money.",
    "Instructions were missing, setup took hours.",
    "Sound quality is crisp and loud.",
    "The zipper broke the first time I used it.",
    "Would buy again, works perfectly.",
    "Arrived late and the box was crushed.",
    "Comfortable, light and warm.",
    "Color is different from the picture.",
    "Does the job, nothing special.",
    "Overheats after ten minutes of use.",
    "Best purchase this year!",
    "Battery lasts two full days, very happy.",      # duplicate row
]


def check(cond, what) -> None:
    """Fail the run (an exception, so a non-zero exit) unless ``cond``."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and error helpers
# ---------------------------------------------------------------------------

_FLUSH = None


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each preceded
    by a 64 MB write that evicts the 50 MB L2 cache.  A spin kernel
    queued first keeps the host ahead of the device, so the events
    bracket device work and not the host's launch overhead."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))                  # ~0.1 s of device time
    pairs = []
    for _ in range(reps):
        _FLUSH.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def usable_cpus() -> int:
    """The CPUs this process may use: its affinity, capped by its cgroup's
    quota (``cpu.max``) where one is set."""
    n = len(os.sched_getaffinity(0))
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()
        if quota != "max":
            n = min(n, max(1, math.ceil(int(quota) / int(period))))
    except (OSError, ValueError):
        pass
    return n


class Background:
    """Card-free work off the card's critical path: the CPU references of
    the training parities and of the compressed all-reduce run on one
    worker thread, in submission order, while the card's phases go on.
    The worker takes its first job once ``open()`` is called (after the
    kernel build, whose nvcc runs it would slow), on half the host's CPUs.  A job returns the line
    its phase emits, or None; ``fence(tag)`` waits for the jobs submitted
    with ``tag`` (all of them without one), emits their lines and
    re-raises the first failure.  A job that moves a process-wide counter
    (``collectives``' counts) carries its name as a tag, and every reader
    of that counter fences on it first.  Without a worker (``start()``
    not called, as in CPU rehearsals) a job runs at once."""

    def __init__(self):
        self._pool, self._jobs, self._open = None, [], threading.Event()
        self.waited_s = 0.0             # the card's phases' time spent in fence()

    def start(self):
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="cpu_reference")

    def open(self):
        self._open.set()

    def run(self, fn, tags=()):
        if self._pool is None:
            out = fn()
            if out is not None:
                emit(out)
            return
        self._jobs.append((self._pool.submit(self._job, fn), set(tags)))

    def _job(self, fn):
        self._open.wait()
        # half the host's CPUs: the main thread and the tiny-olap process
        # (``tiny_phases``) keep cores of their own
        torch.set_num_threads(max(1, usable_cpus() // 2))
        return fn()

    def fence(self, tag=None) -> None:
        t0 = time.time()
        keep = []
        for fut, tags in self._jobs:
            if tag is None or tag in tags:
                out = fut.result()
                if out is not None:
                    emit(out)
            else:
                keep.append((fut, tags))
        self._jobs = keep
        self.waited_s += time.time() - t0

    def close(self):
        """Drop the jobs not begun and wait for the running one."""
        if self._pool is not None:
            self._open.set()
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


BACKGROUND = Background()


def errors(got, want):
    """(max abs error, max abs error / max |want|) in f32."""
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def slot_errors(got, want):
    """(max abs error, the largest over slots of a slot's max abs error over
    that slot's own max |want|) in f32, slots on dim 0.  A long slot's
    outputs average many V rows and are far smaller than a length-1
    slot's (a V row), so a tensor-wide scale would hide its faults."""
    d = (got.float() - want.float()).abs().flatten(1).amax(1)
    scale = want.float().abs().flatten(1).amax(1).clamp(min=1e-30)
    return d.max().item(), (d / scale).max().item()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _turns(fns, rounds: int = 2):
    """Mean time of each of ``fns`` timed in turns (a b b a ...), so a
    drift of the card's clocks weighs on all alike."""
    times = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            times[i].append(time_ms(fns[i]))
    return [sum(t) / len(t) for t in times]


def check_quant_matmul(gen):
    """K2 against its plain version at the main path's shapes and edges:
    decode (M <= 16, one and two n8 tiles of x), prefill tiles and their
    edges (M = 17, 37, 128, 296, 512, 1024), SmoothQuant's ``in_scale`` in
    both regimes, f32 x, ragged N, group 80, q and scale 4 bytes off
    16-byte alignment (the last three on the FMA design), the pruned
    shapes of the OLAP session's ffn75 and kv50 instances, and every
    linear of the trained tiny-olap's grid (TINY_SHAPES at TINY_M rows,
    w8-smooth's ``in_scale``, the 2:4 recipes' zeros).  Each case's
    launch must run the design ``ops.quant_matmul_variant`` names.  Then
    times the bf16 designs against the FMA design they replaced (still in
    the library for f32 and ragged shapes), in turns."""
    from repro_torch.core import quantize as Q
    from repro_torch.core import sparsify as S
    from repro_torch.kernels import ops, ref
    dev = "cuda"
    cache = {}

    def weight(K, N, kind=None, g=gen):
        key = (K, N, kind == "smooth", kind == "nm24")
        if key not in cache:
            w = torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)
            if kind == "smooth":
                amax = torch.rand((K,), generator=g, device=dev) * 4 + 0.5
                cache[key] = Q.absmax_quantize(w, amax_x=amax, smooth_alpha=0.5)
            elif kind == "nm24":      # the 2:4 recipes: 2 of every 4 codes along K are 0
                keep = S.wanda_mask(w, torch.ones(K), n=2, m=4)
                qt = Q.absmax_quantize(torch.where(keep, w, 0.0))
                cache[key] = Q.QTensor(torch.where(keep, qt.q, 0), qt.scale, qt.bits,
                                       qt.group, qt.shape, qt.in_scale)
            else:
                cache[key] = Q.absmax_quantize(w)
        return cache[key]

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(8, K, N, bf16, None) for K, N in
             ((2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216), (9216, 2304))]
    cases += [(M, 2304, N, bf16, None) for M in (1, 8, 296) for N in (1024, 9216)]
    cases += [(37, 2304, 2048, bf16, None), (512, 2304, 9216, bf16, None),
              (512, 9216, 2304, bf16, None), (8, 2304, 2048, bf16, "smooth"),
              (8, 2304, 1024, f32, None), (296, 2304, 1024, f32, "smooth"),
              # ragged N (no 16-byte loads), K not a multiple of the tile, group 80
              (8, 320, 260, bf16, None), (37, 320, 260, f32, None)]
    cases += [(M, 2304, 2048, bf16, None) for M in (16, 17, 128, 1024)]
    cases += [(512, 2304, 9216, bf16, "smooth"), (8, 2304, 1024, bf16, "offset"),
              (296, 2048, 2304, bf16, "offset")]
    # the pruned instances of the OLAP session's search: ffn75 (d_ff 6912)
    # and kv50 (2 KV groups: wq N 1024, wk and wv N 512, attn wo K 1024)
    cases += [(M, K, N, bf16, None) for M in (8, 296) for K, N in PRUNED_SHAPES]
    # the trained tiny-olap's instances: every linear, w8-smooth's in_scale at
    # K 128 and 384, the 2:4 recipes' zeros (base and ffn75 shapes), f32 x
    tiny = [(M, K, N, bf16, None) for M in TINY_M for K, N in TINY_SHAPES]
    tiny += [(M, K, 128, bf16, "smooth") for M in TINY_M for K in (128, 384)]
    tiny += [(M, K, N, bf16, "nm24") for M in TINY_M for K, N in TINY_SHAPES[:7]]
    tiny += [(8, 128, 64, f32, None), (384, 288, 128, f32, "nm24")]
    tgen = torch.Generator(device=dev)
    tgen.manual_seed(TINY_SEED)
    cases = [(c, gen) for c in cases] + [(c, tgen) for c in tiny]
    worst_abs, results = 0.0, []
    for (M, K, N, xdt, kind), g in cases:
        qt = weight(K, N, kind, g)
        q, scale = qt.q, qt.scale
        if kind == "offset":          # the same codes and scales 4 bytes past alignment
            q = torch.empty(K * N + 4, dtype=torch.int8, device=dev)[4:].view(K, N)
            scale = torch.empty(scale.numel() + 1, device=dev)[1:].view(scale.shape)
            q.copy_(qt.q)
            scale.copy_(qt.scale)
        aligned = q.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0
        variant = ops.quant_matmul_variant(xdt, M, N, qt.group, aligned)
        x = torch.randn((M, K), generator=g, device=dev).to(xdt)
        before = dict(ops.variant_count)
        got = ops.quant_matmul(x, q, scale, group=qt.group, in_scale=qt.in_scale)
        want = ref.quant_matmul(x, qt.q, qt.scale, group=qt.group, in_scale=qt.in_scale)
        torch.cuda.synchronize()
        check(got.dtype == xdt and got.shape == (M, N), ("output", got.dtype, got.shape))
        check(variant_delta(before) == {f"quant_matmul.{variant}": 1},
              ("K2 design", M, K, N, xdt, kind, variant_delta(before)))
        err_abs, err_rel = errors(got, want)
        results.append({"M": M, "K": K, "N": N, "x": str(xdt).split(".")[-1],
                        "kind": kind, "group": qt.group, "variant": variant,
                        "rel_err": err_rel})
        check(err_rel < K2_TOL, results[-1])
        worst_abs = max(worst_abs, err_abs)

    def fma(x, qt):                   # the replaced design on the same bf16 input
        return ops._launch_quant_matmul(x[None], qt.q[None], qt.scale[None], qt.group,
                                        "fma")[0]

    # timing: the 7 matmuls of one gemma2-2b layer in one decode step (M=8)
    ms = fma_ms = plain_ms = lib_ms = nbytes = flops = 0.0
    per_shape = []
    # an untimed round first, so the first timed shape is not measured cold
    qt = weight(*LAYER_SHAPES[0])
    x = torch.randn((8, LAYER_SHAPES[0][0]), generator=gen, device=dev).to(bf16)
    time_ms(lambda: ops.quant_matmul(x, qt.q, qt.scale, group=qt.group))
    for K, N in LAYER_SHAPES:
        qt = weight(K, N)
        x = torch.randn((8, K), generator=gen, device=dev).to(bf16)
        wd = ref.dequantize_codes(qt.q, qt.scale, qt.group)
        t_new, t_fma = _turns([lambda: ops.quant_matmul(x, qt.q, qt.scale, group=qt.group),
                               lambda: fma(x, qt)])
        t = (t_new, time_ms(lambda: ref.quant_matmul(x, qt.q, qt.scale, group=qt.group)),
             time_ms(lambda: torch.matmul(x, wd)))
        b = K * N + qt.scale.numel() * 4 + 8 * K * 2 + 8 * N * 2
        per_shape.append({"K": K, "N": N, "ms": t[0], "fma_ms": t_fma, "plain_ms": t[1],
                          "library_ms": t[2], "bound_ms": bound(b, 2 * 8 * K * N)[0]})
        ms, fma_ms, plain_ms, lib_ms = ms + t[0], fma_ms + t_fma, plain_ms + t[1], lib_ms + t[2]
        nbytes += b
        flops += 2 * 8 * K * N
    # prefill-sized product: 8 rows of a 64-token bucket through wi
    qt = weight(2304, 9216)
    x = torch.randn((512, 2304), generator=gen, device=dev).to(bf16)
    wd = ref.dequantize_codes(qt.q, qt.scale, qt.group)
    t_new, t_fma = _turns([lambda: ops.quant_matmul(x, qt.q, qt.scale, group=qt.group),
                           lambda: fma(x, qt)])
    pb, pb_by = bound(2304 * 9216 * 1.0 + qt.scale.numel() * 4 + 512 * (2304 + 9216) * 2,
                      2 * 512 * 2304 * 9216)
    prefill = {"M": 512, "K": 2304, "N": 9216, "variant": "mma", "ms": t_new,
               "fma_ms": t_fma,
               "plain_ms": time_ms(lambda: ref.quant_matmul(x, qt.q, qt.scale, group=qt.group)),
               "library_ms": time_ms(lambda: torch.matmul(x, wd)),
               "bound_ms": pb, "bound_by": pb_by, "bound_share": pb / t_new}
    bound_ms, bound_by = bound(nbytes, flops)
    line = {"phase": "kernel", "name": "quant_matmul", "cases": len(cases),
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "timed": "7 matmuls of one layer, decode M=8, bf16",
            "variant": "decode", "ms": ms, "fma_ms": fma_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "bytes": nbytes, "per_shape": per_shape,
            "prefill": prefill,
            "fma_note": "fma_ms: the FMA design, which the bf16 designs replaced, "
                        "on the same bf16 inputs"}
    emit(line)
    return line, results


def _paged_inputs(gen, dtype, lengths, *, S=8, Kh=4, G=2, D=256, bs=32, nblk=32,
                  alias=False):
    """Pools of the engine's size at max_len 1024, a scrambled table per
    slot and a trash block (the pool's last).  With ``alias`` every slot's
    first two table entries name the same prefix blocks, and entries past
    a slot's length name the trash block, as the engine's tables do."""
    nb = S * nblk + 2 * nblk + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cuda")[:S * nblk]
    tables = perm.reshape(S, nblk).to(torch.int32)      # scrambled, trash block unused
    if alias:
        tables[:, :2] = tables[0, :2]
        used = torch.tensor([-(-n // bs) for n in lengths], device="cuda")
        past = torch.arange(nblk, device="cuda")[None, :] >= used[:, None]
        tables[past] = nb - 1
    q = torch.randn((S, 1, Kh * G, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((nb, bs, Kh, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((nb, bs, Kh, D), generator=gen, device="cuda").to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, tables, ln


def check_paged_attention(gen):
    """K1 against its plain version: the main path's shape at lengths from
    1 to 1024, windows 0, 64 and 4096, softcap 0 and 50; lengths around
    the split boundaries (1, 31, 32, 33, 1024); window 64 with lengths far
    past it; tables aliasing one prefix across slots with the trash block
    past each length; the kv50 instance's layout (Kh = 2, G = 2); another
    head layout and block size; the trained tiny-olap's engines (D 32,
    Kh 2 and its kv50's Kh 1, 5 blocks of 32 a slot).  Each launch must run the ``split`` design.  Then one decode call is timed at 128
    and at 1024 positions a slot."""
    from repro_torch.kernels import ops, ref
    base = [1, 33, 700, 1024, 5, 64, 257, 999]
    edges = [1, 31, 32, 33, 1024, 63, 65, 96]
    past = [1000, 1024, 500, 65, 66, 97, 128, 900]
    tiny = [1, 33, 100, 160, 5, 64, 127, 159]
    tiny_edges = [1, 31, 32, 33, 160, 63, 65, 96]
    cases = [(dtype, window, cap, base, {}) for dtype in (torch.bfloat16, torch.float32)
             for window in (0, 64, 4096) for cap in (0.0, 50.0)]
    for dtype in (torch.bfloat16, torch.float32):
        cases += [(dtype, 0, 50.0, edges, {}), (dtype, 4096, 50.0, edges, {"alias": True}),
                  (dtype, 64, 50.0, past, {}), (dtype, 0, 0.0, base, {"alias": True}),
                  # the kv50 instance of the OLAP session: 2 KV groups, 4 heads
                  (dtype, 4096, 50.0, base, {"Kh": 2, "G": 2}),
                  (dtype, 0, 50.0, edges, {"Kh": 2, "G": 2, "alias": True}),
                  # another head layout and block size than gemma2-2b's
                  (dtype, 40, 30.0, base, {"Kh": 2, "G": 4, "D": 128, "bs": 16, "nblk": 64})]
    # the trained tiny-olap's engines (max_len 160), and its kv50 (Kh 1)
    tgen = torch.Generator(device="cuda")
    tgen.manual_seed(TINY_SEED)
    cases = [(c, gen) for c in cases] + [
        (c, tgen) for dtype in (torch.bfloat16, torch.float32)
        for c in ((dtype, 0, 0.0, tiny, TINY_PA),
                  (dtype, 0, 0.0, tiny_edges, {**TINY_PA, "alias": True}),
                  (dtype, 0, 0.0, tiny, {**TINY_PA, "Kh": 1}))]
    worst_abs, results = 0.0, []
    for (dtype, window, cap, lengths, shape), g in cases:
        q, k, v, tables, ln = _paged_inputs(g, dtype, lengths, **shape)
        before = dict(ops.variant_count)
        got = ops.paged_attention(q, k, v, tables, ln, softcap=cap, window=window)
        S, _, H, D = q.shape
        Kh = k.shape[2]
        want = ref.paged_attention(q[:, 0].reshape(S, Kh, H // Kh, D), k, v, tables,
                                   ln, softcap=cap, window=window).reshape(S, 1, H, D)
        torch.cuda.synchronize()
        err_abs, err_rel = errors(got, want)
        results.append({"dtype": str(dtype).split(".")[-1], "window": window,
                        "softcap": cap, "lengths": lengths, "rel_err": err_rel,
                        "plan": ops.paged_attention_plan(S, Kh, tables.shape[1] * k.shape[1],
                                                         window, k.shape[1]), **shape})
        check(variant_delta(before) == {"paged_attention.split": 1},
              ("K1 design", variant_delta(before)))
        check(got.dtype == dtype and bool(torch.isfinite(got).all())
              and err_rel < K1_TOL[dtype], results[-1])
        worst_abs = max(worst_abs, err_abs)

    # timing: one decode call at the main path's shape, 128 and 1024 live
    # positions a slot, softcap 50, window 4096 (a local layer's call)
    timed = {}
    for L in (128, 1024):
        lengths = [L] * 8
        q, k, v, tables, ln = _paged_inputs(gen, torch.bfloat16, lengths)
        S, _, H, D = q.shape
        Kh, G = 4, 2
        qr = q[:, 0].reshape(S, Kh, G, D)
        kw = dict(softcap=50.0, window=4096)
        ms = time_ms(lambda: ops.paged_attention(q, k, v, tables, ln, **kw))
        plain_ms = time_ms(lambda: ref.paged_attention(qr, k, v, tables, ln, **kw))
        kc = k[tables.long()].reshape(S, -1, Kh, D)[:, :L].permute(0, 2, 1, 3)
        vc = v[tables.long()].reshape(S, -1, Kh, D)[:, :L].permute(0, 2, 1, 3)
        kc = kc.repeat_interleave(G, dim=1).contiguous()
        vc = vc.repeat_interleave(G, dim=1).contiguous()
        qs = q.permute(0, 2, 1, 3).contiguous()
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qs, kc, vc))
        nbytes = sum(lengths) * Kh * D * 2 * 2 + 2 * q.numel() * 2 + tables.numel() * 4 + S * 4
        flops = sum(lengths) * Kh * G * D * 2 * 2
        bound_ms, bound_by = bound(nbytes, flops)
        timed[L] = {"ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_share": bound_ms / ms, "bytes": nbytes,
                    "plan": ops.paged_attention_plan(S, Kh, 1024, 4096, 32)}
    line = {"phase": "kernel", "name": "paged_attention", "cases": len(results),
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "timed": "one decode call, S=8 Kh=4 G=2 D=256 bs=32, 128 positions a slot, "
                     "softcap 50, bf16 (1024 positions under L1024)",
            "variant": "split", **timed[128], "L1024": timed[1024],
            "library_note": "SDPA on K/V gathered and expanded beforehand"}
    emit(line)
    return line, results


# per dtype: the reference's bf16 bound (tests/test_kernels.py), f32 summation order
K34_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def _block_idx(gen, K, N, bs, density):
    """Random kept-block lists, ``keep`` per output block column, sorted."""
    nbi, nbo = K // bs, N // bs
    keep = max(1, int(round(density * nbi)))
    order = torch.rand((nbo, nbi), generator=gen, device="cuda").argsort(dim=1)
    return order[:, :keep].sort(dim=1).values.to(torch.int32)


def check_block_sparse(gen):
    """K4 against its plain version.  The weight is dense random, not
    zero-filled, so a block read outside ``idx`` would show."""
    from repro_torch.kernels import ops, ref
    dev = "cuda"
    shapes = [(2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216), (9216, 2304)]
    Ms = (1, 8, 37, 512)
    cases = [(M, K, N, 16, 0.75, torch.bfloat16) for K, N in shapes for M in Ms]
    cases += [(8, K, N, 16, 0.75, torch.float32) for K, N in shapes]
    i = 0
    for bs in (16, 32, 64, 128):
        for density in (0.25, 0.5, 0.75, 1.0):
            K, N = shapes[i % len(shapes)]
            cases.append((Ms[i % len(Ms)], K, N, bs, density,
                          (torch.bfloat16, torch.float32)[i % 2]))
            i += 1
    # the tensor-core tiles' edges: 9-16 rows (two n8 tiles of x in decode),
    # rows just past a multiple of 16 and of the 128-row prefill tile
    for bs in (16, 32, 64, 128):
        for M in (13, 17, 65, 129):
            K, N = shapes[i % len(shapes)]
            cases.append((M, K, N, bs, 0.75, torch.bfloat16))
            i += 1
    worst_abs, results = 0.0, []
    for n, (M, K, N, bs, density, xdt) in enumerate(cases):
        w = (torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)).bfloat16()
        idx = _block_idx(gen, K, N, bs, density)
        x = torch.randn((M, K), generator=gen, device=dev).to(xdt)
        if n == len(cases) - 1:     # x 2 bytes past a 16-byte boundary
            x = torch.randn((M * K + 1,), generator=gen, device=dev).to(xdt)[1:].view(M, K)
        got = ops.block_sparse_matmul(x, w, idx, bs=bs)
        want = ref.block_sparse_matmul(x, w, idx, bs=bs)
        torch.cuda.synchronize()
        check(got.dtype == xdt and got.shape == (M, N), ("output", got.dtype, got.shape))
        err_abs, err_rel = errors(got, want)
        results.append({"M": M, "K": K, "N": N, "bs": bs, "density": density,
                        "x": str(xdt).split(".")[-1], "rel_err": err_rel,
                        "variant": ops.block_sparse_variant(xdt, M)})
        check(err_rel < K34_TOL[xdt], results[-1])
        worst_abs = max(worst_abs, err_abs)

    # timing: the 7 linears of one layer at bs 16, density 0.75, bf16
    timed = {}
    for M in (8, 512):
        ms = plain_ms = lib_ms = nbytes = flops = panel_flops = 0.0
        warm = True
        for K, N in LAYER_SHAPES:
            idx = _block_idx(gen, K, N, 16, 0.75)
            if M > ops.DECODE_M:
                # the mma design's panels: every input block any column of a
                # 128-wide group keeps, run in full (pruned slots zero-filled)
                panel_flops += 2 * M * 16 * 128 * int(
                    (ops.group_schedule(idx, K // 16, 8) != 0).sum())
            mask = ref.block_mask_from_idx(idx, K // 16)
            big = mask.repeat_interleave(16, 0).repeat_interleave(16, 1)
            w = torch.where(big, torch.randn((K, N), generator=gen, device=dev)
                            / math.sqrt(K), torch.zeros((), device=dev)).bfloat16()
            x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
            if warm:            # an untimed round, so the first shape is not timed cold
                time_ms(lambda: ops.block_sparse_matmul(x, w, idx, bs=16))
                warm = False
            ms += time_ms(lambda: ops.block_sparse_matmul(x, w, idx, bs=16))
            plain_ms += time_ms(lambda: ref.block_sparse_matmul(x, w, idx, bs=16))
            lib_ms += time_ms(lambda: torch.matmul(x, w))
            kept = idx.numel() * 16 * 16
            nbytes += kept * 2 + idx.numel() * 4 + M * K * 2 + M * N * 2
            flops += 2 * M * kept
        bound_ms, bound_by = bound(nbytes, flops)
        timed[M] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_share": bound_ms / ms, "bytes": nbytes, "flops": flops,
                    "variant": ops.block_sparse_variant(torch.bfloat16, M)}
        if M > ops.DECODE_M:
            timed[M]["panel_flops"] = panel_flops
    line = {"phase": "kernel", "name": "block_sparse_matmul", "cases": len(cases),
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "timed": "7 linears of one layer, bs 16, density 0.75, decode M=8, bf16",
            **timed[8], "prefill_M512": timed[512]}
    emit(line)
    return line, results


def _attn_inputs(gen, B, S, T, H, Kh, D, dtype):
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, T, Kh, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, T, Kh, D), generator=gen, device="cuda").to(dtype)
    return q, k, v


def check_flash_attention(gen):
    """K3 against its plain version: the reference's four kernel-test
    shapes (q_offset = T - S), S < T with a padded T and ``t_real``, G of
    1, 2 and 4, D of 64, 128 and 256, S not a multiple of the 64-row tile,
    a window that leaves some rows no live key, bf16 and f32; then the
    tensor-core design's edges: S of 127, 129 and 200 against its 128-row
    tile, T not a multiple of its 64-key stage, and windows that start
    inside a stage, with and without q_offset."""
    from repro_torch.kernels import ops, ref
    # (B, S, T, H, Kh, D, window, softcap, q_offset, t_real)
    shapes = [(2, 64, 64, 4, 2, 64, 0, 0.0, 0, 0),
              (1, 128, 128, 8, 1, 32, 32, 0.0, 0, 0),
              (2, 64, 64, 4, 4, 64, 0, 30.0, 0, 0),
              (1, 64, 192, 2, 2, 32, 0, 0.0, 128, 0),
              (1, 100, 300, 8, 4, 256, 0, 50.0, 150, 250),
              (2, 200, 200, 8, 4, 256, 64, 50.0, 0, 0),
              (1, 130, 130, 8, 2, 128, 0, 0.0, 0, 0),
              (1, 96, 256, 4, 2, 128, 16, 0.0, 0, 40),
              (1, 127, 127, 8, 4, 256, 0, 50.0, 0, 0),
              (2, 129, 129, 8, 4, 256, 0, 50.0, 0, 0),
              (1, 200, 232, 8, 4, 256, 100, 50.0, 32, 0),
              (1, 129, 300, 4, 2, 128, 70, 0.0, 171, 290),
              (1, 256, 256, 8, 8, 64, 29, 30.0, 0, 0)]
    worst_abs, results = 0.0, []
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, T, H, Kh, D, win, cap, off, t_real in shapes:
            q, k, v = _attn_inputs(gen, B, S, T, H, Kh, D, dtype)
            kw = dict(causal=True, window=win, softcap=cap, q_offset=off, t_real=t_real)
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == q.shape, ("output", got.shape))
            err_abs, err_rel = errors(got, want)
            results.append({"B": B, "S": S, "T": T, "H": H, "Kh": Kh, "D": D,
                            "window": win, "softcap": cap, "q_offset": off,
                            "t_real": t_real, "dtype": str(dtype).split(".")[-1],
                            "rel_err": err_rel, "variant": ops.flash_variant(dtype)})
            check(bool(torch.isfinite(got).all()) and err_rel < K34_TOL[dtype], results[-1])
            worst_abs = max(worst_abs, err_abs)

    # timing: one gemma2-2b layer's prefill attention at S = T = 4096 and
    # 8192, bf16
    B, H, Kh, D = 1, 8, 4, 256
    timed = {}
    for S, win in ((4096, 0), (4096, 4096), (8192, 0)):
        q, k, v = _attn_inputs(gen, B, S, S, H, Kh, D, torch.bfloat16)
        kw = dict(causal=True, window=win, softcap=50.0)
        t = {"ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw), reps=10),
             "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v, **kw), reps=3)}
        if win == 0:
            qs = q.transpose(1, 2).contiguous()
            ks = k.transpose(1, 2).repeat_interleave(H // Kh, dim=1).contiguous()
            vs = v.transpose(1, 2).repeat_interleave(H // Kh, dim=1).contiguous()
            t["library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True), reps=10)
            # live causal (query, key) pairs, each a D-long QK dot and a D-long PV sum
            t["flops"] = 4.0 * B * H * D * (S * (S + 1) / 2)
            t["bound_ms"], t["bound_by"] = bound(2 * (q.numel() * 2 + k.numel() + v.numel()),
                                                 t["flops"])
            t["bound_share"] = t["bound_ms"] / t["ms"]
            del qs, ks, vs
        timed[S, win] = t
    line = {"phase": "kernel", "name": "flash_attention", "cases": len(results),
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "timed": "one prefill call, B=1 S=T=4096 H=8 Kh=4 D=256, causal, softcap 50, "
                     "bf16, window 0 (window 4096 and S=T=8192 under their keys)",
            **timed[4096, 0], "variant": ops.flash_variant(torch.bfloat16),
            "library_note": "SDPA is_causal, no softcap, KV heads pre-expanded",
            "window_4096": timed[4096, 4096], "S_8192": timed[8192, 0]}
    emit(line)
    return line, results


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def serve(params, cfg, version, device="cuda", kv_layout="auto"):
    """The main path's rows through ``Engine(slots=8, max_len=1024)``."""
    from repro_torch.serving.engine import Engine
    eng = Engine(params, cfg, slots=8, max_len=1024, backend="auto", version=version,
                 device=device, kv_layout=kv_layout)
    sync()
    reqs = eng.generate([TEMPLATE + r for r in REVIEWS], max_new=32, prefix=TEMPLATE,
                        return_requests=True)
    sync()
    st = eng.stats
    check(all(r.done for r in reqs), "unfinished rows")
    check(st.rows == len(REVIEWS) and st.backend == ("cuda" if device == "cuda"
                                                     else "reference"), st)
    check(st.prefix_hits > 0 and st.cache_hits >= 1, st)
    for r in reqs:
        check(1 <= len(r.out_ids) <= 32 and all(0 <= t < cfg.vocab_size for t in r.out_ids),
              ("row tokens", r.out_ids))
        check(math.isfinite(r.confidence) and 0.0 <= r.confidence <= 1.0,
              ("row confidence", r.confidence))
    return eng, reqs


def _agreement(reqs_a, reqs_b):
    """(greedy token agreement over the common prefix of each pair of
    rows, rows identical) of two runs of the same prompts."""
    same = tot = rows_same = 0
    for a, b in zip(reqs_a, reqs_b):
        n = min(len(a.out_ids), len(b.out_ids))
        same += sum(x == y for x, y in zip(a.out_ids[:n], b.out_ids[:n]))
        tot += n
        rows_same += a.out_ids == b.out_ids
    return same / max(tot, 1), rows_same


def _serve_stats(eng, prefixes):
    """An engine's serving numbers and the template prefixes it built."""
    st = eng.stats
    return {"rows_per_s": st.rows_per_s, "tokens_per_s": st.tokens_out / st.wall_s,
            "wall_s": st.wall_s, "decode_steps": st.decode_steps,
            "prefills": st.prefills, "prefix_hits": st.prefix_hits,
            "cache_hits": st.cache_hits, "truncated": st.truncated,
            "prefill_tokens": st.prefill_tokens,
            "prefill_tokens_saved": st.prefill_tokens_saved, "template_prefixes": prefixes}


def main_path(gen):
    from repro_torch.configs import gemma2_2b
    from repro_torch.core.compressed import param_bytes
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.kernels import ops
    from repro_torch.models import api

    cfg = gemma2_2b.CONFIG
    t0 = time.time()
    base = api.init_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    t0 = time.time()
    int8, _, report = InstanceOptimizer(base, cfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    torch.cuda.synchronize()
    quant_s = time.time() - t0

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    eng8, reqs8 = serve(int8, cfg, "w8-absmax")
    launches = dict(ops.launch_count)
    variants = {k: n for k, n in ops.variant_count.items() if n}
    st8, per_step = eng8.stats, 7 * cfg.n_layers
    check(launches == {"quant_matmul": per_step * (st8.decode_steps + st8.prefills),
                       "paged_attention": cfg.n_layers * st8.decode_steps,
                       "block_sparse_matmul": 0, "flash_attention": 0},
          ("int8 run launches", launches, st8.decode_steps, st8.prefills))
    # bf16 throughout: decode steps (8 rows) on K2's `decode`, bucketed
    # prefills on `mma`, never `fma`; K1 on `split`
    check(variants == {"quant_matmul.decode": per_step * st8.decode_steps,
                       "quant_matmul.mma": per_step * st8.prefills,
                       "paged_attention.split": launches["paged_attention"]},
          ("int8 run designs", variants))
    peak = torch.cuda.max_memory_allocated()

    ops.reset_launch_counts()
    eng16, reqs16 = serve(base, cfg, "base")
    base_launches = dict(ops.launch_count)
    base_variants = {k: n for k, n in ops.variant_count.items() if n}
    check(base_launches["paged_attention"] > 0 and base_launches["quant_matmul"] == 0
          and base_variants == {"paged_attention.split": base_launches["paged_attention"]},
          (base_launches, base_variants))

    agree, rows_same = _agreement(reqs16, reqs8)
    line = {"phase": "main_path", "model": cfg.name, "layers": cfg.n_layers,
            "rows": len(REVIEWS), "max_new": 32, "init_s": init_s, "quantize_s": quant_s,
            "param_bytes_base": param_bytes(base), "param_bytes_int8": param_bytes(int8),
            "compression": report.compression,
            "int8": {"rows_per_s": eng8.stats.rows_per_s,
                     "tokens_per_s": eng8.stats.tokens_out / eng8.stats.wall_s,
                     "wall_s": eng8.stats.wall_s, "decode_steps": eng8.stats.decode_steps,
                     "prefills": eng8.stats.prefills, "prefix_hits": eng8.stats.prefix_hits,
                     "cache_hits": eng8.stats.cache_hits, "backend": eng8.stats.backend,
                     "launches": launches, "variants": variants},
            "base": {"rows_per_s": eng16.stats.rows_per_s,
                     "tokens_per_s": eng16.stats.tokens_out / eng16.stats.wall_s,
                     "wall_s": eng16.stats.wall_s, "decode_steps": eng16.stats.decode_steps,
                     "prefix_hits": eng16.stats.prefix_hits, "backend": eng16.stats.backend,
                     "launches": base_launches},
            "max_memory_allocated_int8_run": peak,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "greedy_token_agreement_base_vs_int8": agree,
            "rows_identical_base_vs_int8": rows_same}
    emit(line)
    for name in ("int8", "base"):
        print(f"{name}: {line[name]['rows_per_s']:.3f} rows/s, "
              f"{line[name]['tokens_per_s']:.1f} tokens/s", flush=True)
    print(f"param_bytes: base {line['param_bytes_base']}, int8 {line['param_bytes_int8']}",
          flush=True)
    print(f"max_memory_allocated: {line['max_memory_allocated']}", flush=True)
    print(f"greedy agreement base vs int8: {line['greedy_token_agreement_base_vs_int8']:.4f}",
          flush=True)
    return line, launches, variants, base, int8, eng8


# ---------------------------------------------------------------------------
# qembed_serve: gemma2-2b's tied table as int8 codes (QEmbed)
# ---------------------------------------------------------------------------

QEMBED_SEED = 73                 # the phase's own inputs: no other phase's draw moves
# 256000 x 2304 bf16 (1,179,648,000 B) against int8 codes and f32 row scales
# (589,824,000 + 1,024,000 B)
QEMBED_SAVED = 588_800_000
# f32 logits of bf16 operands against the f32 product of the same operands
# upcast: f32 accumulation in another order, about 1e-6 of the largest
# logit; rounding the logits through bf16 puts them about 3.5e-3 of it away
TIED_RTOL = 2e-5
QEMBED_M = (8, 512)


def qembed_serve(base, cfg, device="cuda"):
    """``w8-absmax`` and the same recipe with ``quant_embed=True`` built by
    ``InstanceOptimizer`` from the full-width base, each served on the
    paged ``Engine`` (``serve``): the ``QEmbed`` instance saves exactly
    QEMBED_SAVED more bytes, launches K1 and K2 on every step as the int8
    run of ``main_path`` does, and serves the ``w8-absmax`` rows but where
    they part at a near tie (``tie_at`` on the ``w8-absmax`` instance's
    f32 path, sigma from the ``QEmbed`` instance's bf16 path; a control row
    given another row's ids must not pass).  The tied product and
    ``QEmbed.logits`` are held at M = 8 against the f32 product of their
    bf16 operands (TIED_RTOL) and timed at QEMBED_M beside their bounds."""
    from repro_torch.core.compressed import tied_logits
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.kernels import ops

    opt = InstanceOptimizer(base, cfg)
    w8, _, rep = opt.apply(Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    t0 = time.time()
    qe, _, rep_qe = opt.apply(Recipe(name="w8-absmax-qembed", wbits=8, quant_method="absmax",
                                     quant_embed=True))
    sync()
    build_s = time.time() - t0
    saved, saved_qe = rep.bytes_before - rep.bytes_after, rep_qe.bytes_before - rep_qe.bytes_after
    table = base["embed"]
    V, d = table.shape
    want_saved = V * d * table.element_size() - (V * d + 4 * V)
    check(saved_qe - saved == want_saved, ("QEmbed bytes", saved_qe - saved, want_saved))
    check((V, d) != (256000, 2304) or want_saved == QEMBED_SAVED, ("gemma2-2b", want_saved))

    _, reqs_w8 = serve(w8, cfg, "w8-absmax", device=device)
    ops.reset_launch_counts()
    eng, reqs = serve(qe, cfg, "w8-absmax-qembed", device=device)
    launches = dict(ops.launch_count)
    st = eng.stats
    on_card = torch.device(device).type == "cuda"
    check(not on_card or launches == {
        "quant_matmul": 7 * cfg.n_layers * (st.decode_steps + st.prefills),
        "paged_attention": cfg.n_layers * st.decode_steps,
        "block_sparse_matmul": 0, "flash_attention": 0},
        ("QEmbed run launches", launches, st.decode_steps, st.prefills))
    agree, rows_same = _agreement(reqs_w8, reqs)
    prompts = [TEMPLATE + r for r in REVIEWS]
    top, p32, parted = max(eng.buckets), _f32(w8), []
    for prompt, a, b in zip(prompts, reqs, reqs_w8):
        if a.out_ids != b.out_ids:
            parted.append({"prompt": prompt, **tie_at(w8, cfg, eng.tok, prompt, a.out_ids,
                                                      b.out_ids, top, p32, noisy=qe)})
    # the control: row 0 given the ids of the first row whose first token differs
    donor = next(r for r in reqs_w8 if r.out_ids[:1] != reqs_w8[0].out_ids[:1])
    control = tie_at(w8, cfg, eng.tok, prompts[0], donor.out_ids, reqs_w8[0].out_ids, top,
                     p32, noisy=qe)
    del p32
    check(all(r["near_tie"] for r in parted), ("QEmbed rows part off a near tie", parted))
    check(not control["near_tie"], ("the control row passed as a near tie", control))

    # the tied product and QEmbed.logits against the f32 product of their operands
    gen = torch.Generator(device=device)
    gen.manual_seed(QEMBED_SEED)
    qt = qe["embed"]
    x8 = torch.randn((8, d), generator=gen, device=device).to(torch.bfloat16)
    want = x8.float() @ table.float().t()
    tied_err = errors(tied_logits(x8, table), want)
    rounded_err = errors(torch.matmul(x8, table.t()).float(), want)
    del want
    q_err = errors(qt.logits(x8), (x8.float() @ qt.q.float().t()) * qt.scale)
    check(tied_err[1] <= TIED_RTOL and q_err[1] <= TIED_RTOL,
          ("f32 logits", tied_err, q_err, TIED_RTOL))
    timing = {}
    for M in QEMBED_M if on_card else ():
        x = torch.randn((M, d), generator=gen, device=device).to(torch.bfloat16)
        out = M * V * 4 + M * d * 2
        t_tied, t_q = _turns([lambda: tied_logits(x, table), lambda: qt.logits(x)])
        timing[f"M{M}"] = {
            "tied_ms": t_tied, "qembed_ms": t_q,
            "tied_bound_ms": bound(V * d * 2 + out, 2.0 * M * V * d)[0],
            "qembed_bound_ms": bound(V * d + 4 * V + out, 2.0 * M * V * d)[0]}
    line = {"phase": "qembed_serve", "model": cfg.name, "build_s": build_s,
            "bytes_before": rep.bytes_before, "bytes_after_w8": rep.bytes_after,
            "bytes_after_qembed": rep_qe.bytes_after, "saved_extra": saved_qe - saved,
            "params_after_w8": rep.params_after, "params_after_qembed": rep_qe.params_after,
            "launches": launches, "decode_steps": st.decode_steps, "prefills": st.prefills,
            "rows_per_s": st.rows_per_s, "tokens_per_s": st.tokens_out / st.wall_s,
            "greedy_token_agreement_vs_w8": agree, "rows_identical_vs_w8": rows_same,
            "parted": parted, "control": control,
            "tied_max_abs_err": tied_err[0], "tied_max_rel_err": tied_err[1],
            "qembed_max_abs_err": q_err[0], "qembed_max_rel_err": q_err[1],
            "bf16_rounded_max_abs_err": rounded_err[0],
            "bf16_rounded_max_rel_err": rounded_err[1], "tol_rel": TIED_RTOL,
            "timing": timing}
    del w8, qe, eng, reqs, reqs_w8
    emit(line)
    print(f"qembed_serve: {line['saved_extra']} more bytes saved, rows identical "
          f"{rows_same}/{len(REVIEWS)}, tied logits rel err {tied_err[1]:.2e} "
          f"(bf16-rounded {rounded_err[1]:.2e})", flush=True)
    return line, launches


# ---------------------------------------------------------------------------
# phase 4: one decode step, cuda backend vs reference backend
# ---------------------------------------------------------------------------

def _f32(tree):
    """The param tree with every float tensor in f32 (QTensors stay)."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.float()
    return tree


def variant_delta(before):
    """Launches per kernel design since ``before``, zero entries dropped."""
    from repro_torch.kernels import ops
    d = {k: ops.variant_count[k] - before[k] for k in before}
    return {k: n for k, n in d.items() if n}


def variants_of(launched, dtype, rows, G: int = 2):
    """The designs that the kernels' launches must have run for params of
    ``dtype`` and x of ``rows`` rows (0: prefill-sized), with ``G`` query
    heads per KV head.  K2's rule sees gemma2-2b's linears, whose N are all
    multiples of 16, and w8-absmax's groups of 128 rows."""
    from repro_torch.kernels import ops
    rows = rows or 10**6
    want = {}
    if launched.get("quant_matmul"):
        key = f"quant_matmul.{ops.quant_matmul_variant(dtype, rows, 2304, 128)}"
        want[key] = launched["quant_matmul"]
    if launched.get("paged_attention"):
        want[f"paged_attention.{ops.paged_attention_variant(dtype, G)}"] = \
            launched["paged_attention"]
    if launched.get("flash_attention"):
        want[f"flash_attention.{ops.flash_variant(dtype)}"] = launched["flash_attention"]
    if launched.get("block_sparse_matmul"):
        key = f"block_sparse_matmul.{ops.block_sparse_variant(dtype, rows)}"
        want[key] = launched["block_sparse_matmul"]
    return want


def whole_step(gen, params, eng, per_step, trials: int = 6, name="whole_step"):
    """One decode step of a compressed instance under
    ``kernel_backend("cuda")`` and under ``kernel_backend("reference")`` on
    the same state (the served rows' pools, a scrambled table, random
    tokens), in bf16 as served and in f32 (float params and pools cast;
    int8 codes and block-sparse bf16 tiles stay), over a few random inputs.
    The launch counts show that each cuda side ran ``per_step`` launches
    of each kernel and each reference side none."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.kernels import ops
    from repro_torch.models import api
    cfg = eng.cfg
    S, bs = eng.slots, eng._block_size
    nblk = eng.max_len // bs
    pos = torch.tensor([90, 95, 100, 105, 110, 115, 120, 600], device=eng.device)
    p32 = _f32(params)
    rms = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    results = []
    for _ in range(trials):
        perm = torch.randperm(eng._alloc.num_blocks - 1, generator=gen, device=eng.device)
        tables = perm[:S * nblk].reshape(S, nblk).to(torch.int32)
        toks = torch.randint(4, 260, (S, 1), generator=gen, device=eng.device)
        logits = {}
        for dtype, p in ((torch.bfloat16, params), (torch.float32, p32)):
            for backend in ("cuda", "reference"):
                st = {sec: [{n: t.to(dtype, copy=True) for n, t in e.items()}
                            for e in eng._slot_state[sec]] for sec in ("blocks", "tail")}
                before = dict(ops.launch_count)
                vbefore = dict(ops.variant_count)
                with kernel_backend(backend), torch.no_grad():
                    lg, _ = api.paged_decode_step(p, cfg, st, tables, toks, pos,
                                                  block_size=bs, max_len=eng.max_len)
                launched = {k: ops.launch_count[k] - before[k] for k in before}
                want = {k: per_step.get(k, 0) if backend == "cuda" else 0 for k in before}
                check(launched == want, ("launches of the step", dtype, backend, launched))
                check(variant_delta(vbefore) == variants_of(launched, dtype, S,
                                                            cfg.n_heads // cfg.n_kv_heads),
                      ("designs of the step", dtype, backend, variant_delta(vbefore)))
                check(bool(torch.isfinite(lg).all()) and lg.shape == (S, 1, cfg.vocab_size),
                      ("decode-step logits", dtype, backend, lg.shape))
                logits[dtype, backend] = lg.float()
        c16, r16 = logits[torch.bfloat16, "cuda"], logits[torch.bfloat16, "reference"]
        c32, r32 = logits[torch.float32, "cuda"], logits[torch.float32, "reference"]
        results.append({
            "f32_rms_rel_err": rms(c32, r32), "f32_max_abs_err": errors(c32, r32)[0],
            "bf16_rms_rel_err": rms(c16, r16), "bf16_max_rel_err": errors(c16, r16)[1],
            "bf16_cuda_vs_f32": rms(c16, r32), "bf16_plain_vs_f32": rms(r16, r32),
            "greedy_agreement_bf16":
                (c16[:, -1].argmax(-1) == r16[:, -1].argmax(-1)).float().mean().item(),
            "greedy_agreement_f32":
                (c32[:, -1].argmax(-1) == r32[:, -1].argmax(-1)).float().mean().item()})
    cuda_err = sum(r["bf16_cuda_vs_f32"] for r in results)
    plain_err = sum(r["bf16_plain_vs_f32"] for r in results)
    line = {"phase": name, "trials": results,
            "tolerance_f32_rms_rel": STEP_TOL_F32, "bf16_ratio_bound": STEP_BF16_RATIO,
            "bf16_ratio": cuda_err / plain_err, "launches_per_step": per_step}
    emit(line)
    agree = sum(r["greedy_agreement_bf16"] for r in results) / trials
    print(f"{name}: decode step cuda vs reference: greedy agreement {agree:.3f} (bf16), "
          f"f32 RMS error up to {max(r['f32_rms_rel_err'] for r in results):.2e}", flush=True)
    check(all(r["f32_rms_rel_err"] < STEP_TOL_F32 for r in results), line)
    check(cuda_err <= STEP_BF16_RATIO * plain_err, line)
    return line


# ---------------------------------------------------------------------------
# phase block_sparse: calibrate, compress with bs16@75, serve
# ---------------------------------------------------------------------------

def calibration_tokens(device, rows: int = 16, seq: int = 96):
    """The first ``rows`` template rows, tokenized and right-padded to
    ``seq`` tokens (the calibration sample of ``benchmarks/ablation.py``)."""
    from repro_torch.training.data import ByteTokenizer
    tok = ByteTokenizer()
    toks, _ = tok.pad_batch([tok.encode(TEMPLATE + r, bos=True) for r in REVIEWS[:rows]],
                            seq_len=seq)
    return torch.from_numpy(toks).to(device)


def block_sparse_path(base, cfg):
    """The slice's main path: calibrate the bf16 base on a sample of the
    rows (activation norms only: the block recipe reads no Hessian), apply
    ``bs16@75`` and serve the rows.  The launch counts are zeroed just
    before the run and read just after."""
    from repro_torch.core.compressed import BlockSparseTensor, param_bytes
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.kernels import ops
    per_step = 7 * cfg.n_layers
    opt = InstanceOptimizer(base, cfg)
    t0 = time.time()
    opt.run_calibration({"tokens": calibration_tokens(base["embed"].device)}, hessian=False)
    torch.cuda.synchronize()
    calib_s = time.time() - t0
    t0 = time.time()
    bsp, _, report = opt.apply(Recipe(name="bs16@75", block_bs=16, block_density=0.75))
    torch.cuda.synchronize()
    apply_s = time.time() - t0
    linears = [w for blk in bsp["blocks"] for sub in ("attn", "mlp") for w in blk[sub].values()]
    check(len(linears) * len(bsp["blocks"][0]["mlp"]["wi"].w) == per_step
          and all(isinstance(w, BlockSparseTensor) and w.idx.shape[0] == w.w.shape[0]
                  and abs(w.density() - 0.75) < 1e-6 for w in linears),
          "every linear of every layer block-sparse at 0.75, with its own indices")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    eng, reqs = serve(bsp, cfg, "bs16@75")
    launches = dict(ops.launch_count)
    st = eng.stats
    variants = {k: n for k, n in ops.variant_count.items() if n}
    check(launches == {"quant_matmul": 0, "flash_attention": 0,
                       "paged_attention": cfg.n_layers * st.decode_steps,
                       "block_sparse_matmul": per_step * (st.decode_steps + st.prefills)},
          ("block-sparse run launches", launches, st.decode_steps, st.prefills))
    # bf16 throughout: decode steps (8 rows) on `decode`, prefills on `mma`
    check(variants == {"block_sparse_matmul.decode": per_step * st.decode_steps,
                       "block_sparse_matmul.mma": per_step * st.prefills,
                       "paged_attention.split": launches["paged_attention"]},
          ("block-sparse run designs", variants))
    line = {"phase": "block_sparse", "model": cfg.name, "recipe": "bs16@75",
            "calibration_rows": 16, "calibration_tokens": 96, "calibrate_s": calib_s,
            "apply_s": apply_s, "rows": len(REVIEWS), "max_new": 32,
            "rows_per_s": st.rows_per_s, "tokens_per_s": st.tokens_out / st.wall_s,
            "wall_s": st.wall_s, "decode_steps": st.decode_steps, "prefills": st.prefills,
            "prefix_hits": st.prefix_hits, "cache_hits": st.cache_hits,
            "backend": st.backend, "launches": launches, "variants": variants,
            "block_sparse_per_decode_step": per_step,
            "param_bytes_base": param_bytes(base), "param_bytes": param_bytes(bsp),
            "compression": report.compression,
            "max_memory_allocated_run": torch.cuda.max_memory_allocated(),
            "memory_note": "the weights stay dense and zero-filled on the card: "
                           "param_bytes counts kept tiles, device memory does not shrink"}
    emit(line)
    print(f"bs16@75: {line['rows_per_s']:.3f} rows/s, {line['tokens_per_s']:.1f} tokens/s, "
          f"calibrate {calib_s:.2f} s, apply {apply_s:.2f} s, param_bytes "
          f"{line['param_bytes']} (device memory unchanged: dense zero-filled tiles)",
          flush=True)
    return line, launches, variants, bsp, eng


# ---------------------------------------------------------------------------
# phase long_prefill: flash prefill of long documents
# ---------------------------------------------------------------------------

LONG_S, LONGEST_S = 4096, 8192


def long_prefill(gen, base, cfg):
    """Two long documents, each prefilled under the cuda and the reference
    backends, in bf16 and f32, and held to the whole-step criteria: one of
    LONG_S tokens with ``use_flash=True`` (every layer runs K3), and one
    of LONGEST_S tokens without it, whose global layers take
    ``best_attention``'s long-sequence branch (K3 on the cuda side, its
    plain version, one tile of memory, on the reference side)."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.kernels import ops
    from repro_torch.models import api
    dev = base["embed"].device
    rms = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731

    def run(params, toks, backend, use_flash, flash_launches):
        before = dict(ops.launch_count)
        vbefore = dict(ops.variant_count)
        t0 = time.time()
        with kernel_backend(backend), torch.no_grad():
            lg, _ = api.prefill(params, cfg, {"tokens": toks}, max_len=toks.shape[1],
                                compact_local=False, use_flash=use_flash)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launched = {k: ops.launch_count[k] - before[k] for k in before}
        check(launched == {k: flash_launches if k == "flash_attention" else 0
                           for k in before}, ("prefill launches", backend, launched))
        check(variant_delta(vbefore) == variants_of(launched, params["embed"].dtype, 0),
              ("prefill designs", backend, variant_delta(vbefore)))
        check(lg.shape == (1, toks.shape[1], cfg.vocab_size)
              and bool(torch.isfinite(lg).all()), ("prefill logits", backend, lg.shape))
        return lg, secs

    def compare(S, use_flash, flash_launches):
        toks = torch.randint(4, 260, (1, S), generator=gen, device=gen.device).to(dev)
        logits, secs = {}, {}
        for dtype in (torch.bfloat16, torch.float32):
            params = base if dtype == torch.bfloat16 else _f32(base)
            for backend in ("cuda", "reference"):
                lg, secs[f"{backend}_{str(dtype)[6:]}"] = run(
                    params, toks, backend, use_flash,
                    flash_launches if backend == "cuda" else 0)
                logits[dtype, backend] = lg
            del params
        c16, r16 = logits[torch.bfloat16, "cuda"], logits[torch.bfloat16, "reference"]
        c32, r32 = logits[torch.float32, "cuda"], logits[torch.float32, "reference"]
        res = {"S": S, "use_flash": use_flash, "flash_launches": flash_launches,
               "f32_rms_rel_err": rms(c32, r32), "f32_max_abs_err": errors(c32, r32)[0],
               "bf16_rms_rel_err": rms(c16, r16), "bf16_cuda_vs_f32": rms(c16, r32),
               "bf16_plain_vs_f32": rms(r16, r32),
               "greedy_agreement_f32":
                   (c32[0].argmax(-1) == r32[0].argmax(-1)).float().mean().item(),
               "greedy_agreement_bf16":
                   (c16[0].argmax(-1) == r16[0].argmax(-1)).float().mean().item(),
               "seconds": secs}
        res["bf16_ratio"] = res["bf16_cuda_vs_f32"] / res["bf16_plain_vs_f32"]
        del logits, c16, r16, c32, r32
        torch.cuda.empty_cache()
        return res

    flash = compare(LONG_S, True, cfg.n_layers)
    longest = compare(LONGEST_S, False, cfg.pattern().count("G"))
    line = {"phase": "long_prefill", "model": cfg.name, "flash": flash, "longest": longest,
            "tolerance_f32_rms_rel": STEP_TOL_F32, "bf16_ratio_bound": STEP_BF16_RATIO}
    emit(line)
    for res in (flash, longest):
        print(f"prefill S={res['S']} use_flash={res['use_flash']}: {res['flash_launches']} "
              f"K3 launches, f32 RMS error {res['f32_rms_rel_err']:.2e}, bf16 ratio "
              f"{res['bf16_ratio']:.3f}, cuda bf16 in {res['seconds']['cuda_bfloat16']:.2f} s",
              flush=True)
        check(res["f32_rms_rel_err"] < STEP_TOL_F32, line)
        check(res["bf16_cuda_vs_f32"] <= STEP_BF16_RATIO * res["bf16_plain_vs_f32"], line)
    return line


# ---------------------------------------------------------------------------
# phase olap_session: Query -> per-query calibration and recipe search ->
# the picked instance served through Engine
# ---------------------------------------------------------------------------

SESSION_KW = dict(objective="perf", calib_rows=16, eval_rows=8,
                  engine_kw=dict(slots=8, max_len=1024, buckets=(32, 64, 128)))
SEARCH_MAX_NEW = 12             # greedy tokens per eval row (the session's)


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def session_recipes(cfg):
    """The grid, and the session's recipes: the grid's ``w8-absmax`` and
    absmax copies of its ``w8-ffn75`` and ``w8-kv50`` (the grid has no
    ``w8-kv50`` for rwkv, which has no attention, nor for a model of one
    KV head, paligemma: two recipes)."""
    import dataclasses
    from repro_torch.core import policy as POL
    grid = {r.name: r for r in POL.default_recipe_space(cfg)}
    check(grid["w8-ffn75"].ffn_keep_frac == 0.75, ("grid recipe", grid["w8-ffn75"]))
    recipes = [grid["w8-absmax"],
               dataclasses.replace(grid["w8-ffn75"], name="w8a-ffn75", quant_method="absmax")]
    if cfg.family == "rwkv" or cfg.n_kv_heads < 2:
        check("w8-kv50" not in grid, ("grid without w8-kv50", sorted(grid)))
        return grid, recipes
    check(grid["w8-kv50"].kv_keep_frac == 0.5, ("grid recipe", grid["w8-kv50"]))
    return grid, recipes + [dataclasses.replace(grid["w8-kv50"], name="w8a-kv50",
                                                quant_method="absmax")]


class SessionProbe:
    """Instruments a session from outside the package, for the length of a
    ``with`` block: ``policy.search`` (each search's candidates, seconds and
    kernel designs launched), ``InstanceOptimizer.run_calibration`` and
    ``apply`` (seconds, the device synchronized around each), and the
    ``Engine`` the session or its model pool builds (each engine's stats
    and, with ``ids``, each row's token ids by prompt in ``ids`` and by
    (model version, prompt) in ``vids``, and its confidence by (model
    version, prompt) in ``vconf``)."""

    def __init__(self, ids: bool = False, on_search=None, on_outcome=None):
        self.searches, self.calibrations, self.applies, self.engines = [], [], [], []
        self.ids = {} if ids else None
        self.vids = {} if ids else None
        self.vconf = {} if ids else None
        self.on_search = on_search
        self.on_outcome = on_outcome

    def __enter__(self):
        from repro_torch.core import policy as POL
        from repro_torch.core.pipeline import InstanceOptimizer
        from repro_torch.kernels import ops
        from repro_torch.olap import query as Q
        from repro_torch.serving import scheduler as SCH
        self._saved = [(POL, "search", POL.search),
                       (InstanceOptimizer, "run_calibration", InstanceOptimizer.run_calibration),
                       (InstanceOptimizer, "apply", InstanceOptimizer.apply),
                       (Q, "Engine", Q.Engine), (SCH, "Engine", SCH.Engine)]
        real_search, real_calib, real_apply, real_engine = (s[2] for s in self._saved[:4])
        probe = self

        def search(optimizer, eval_fn, recipes, **kw):
            sync()
            before, t0 = dict(ops.variant_count), time.time()
            per_eval = []              # kernel designs of each evaluation, baseline first

            def counted(params, cfg):
                b = dict(ops.variant_count)
                res = eval_fn(params, cfg)
                per_eval.append(variant_delta(b))
                return res

            out = real_search(optimizer, counted, recipes, **kw)
            sync()
            probe.searches.append({
                "seconds": time.time() - t0, "recipes": [r.name for r in recipes],
                "peak_memory": torch.cuda.max_memory_allocated(),
                "baseline_rows_per_s": out.baseline.rows_per_s,
                "picked": out.perf.recipe.name if out.perf else None,
                "variants": variant_delta(before),
                "candidates": [{"recipe": c.recipe.name, "eval_rows_per_s": c.result.rows_per_s,
                                "accuracy": c.result.accuracy,
                                "token_agreement": c.result.token_agreement,
                                "param_bytes": c.result.bytes, "n_layers": c.cfg.n_layers,
                                "d_ff": c.cfg.d_ff, "n_heads": c.cfg.n_heads,
                                "n_kv_heads": c.cfg.n_kv_heads, "variants": v}
                               for c, v in zip(out.candidates, per_eval[1:])]})
            if probe.on_search is not None:
                probe.on_search(optimizer)
            if probe.on_outcome is not None:
                probe.on_outcome(optimizer, out)
            return out

        def run_calibration(opt, batch, **kw):
            sync()
            t0 = time.time()
            stats = real_calib(opt, batch, **kw)
            sync()
            probe.calibrations.append({"seconds": time.time() - t0,
                                       "tokens": list(batch["tokens"].shape),
                                       "memory_after": torch.cuda.memory_allocated()})
            return stats

        def apply(opt, recipe):
            sync()
            t0 = time.time()
            out = real_apply(opt, recipe)
            sync()
            probe.applies.append({"recipe": recipe.name, "seconds": time.time() - t0})
            return out

        def engine(*a, **k):
            e = real_engine(*a, **k)
            probe.engines.append({"version": e.version, "stats": e.stats,
                                  "n_layers": e.cfg.n_layers})
            if probe.ids is not None:
                retire = e._retire

                def record(req):
                    probe.ids[req.src] = list(req.out_ids)
                    probe.vids[e.version, req.src] = list(req.out_ids)
                    probe.vconf[e.version, req.src] = req.confidence
                    return retire(req)
                e._retire = record
            return e

        POL.search, InstanceOptimizer.run_calibration = search, run_calibration
        InstanceOptimizer.apply, Q.Engine, SCH.Engine = apply, engine, engine
        return self

    def __exit__(self, *exc):
        for obj, name, val in self._saved:
            setattr(obj, name, val)
        return False


def _block_key(v: str) -> str:
    """The fuzzy join's blocking key, recomputed here to predict its pairs."""
    return "".join(ch for ch in str(v).lower() if ch.isalnum())[:1]


def olap_queries(sess):
    """Q1-Q4 of ``examples/olap_queries.py`` at 64 rows (Q3: 16 x 16
    names), and Q5: Q2's table as a forced cascade with budget 0.25.
    Returns [(name, query, input rows, expected output rows, expected
    columns, expected invocations or None)]."""
    from repro_torch.olap.query import Query
    from repro_torch.olap.table import Table
    from repro_torch.training.data import PROMPTS, workload_rows
    reviews = Table({"review": [r.text for r in workload_rows("summarize", 64)]})
    commits = Table({"lang": [r.text for r in workload_rows("correct", 64)]})
    pairs = workload_rows("join", 16)
    left = Table({"name": [p.text.split(" | ")[0] for p in pairs]})
    right = Table({"name": [p.text.split(" | ")[1] for p in pairs]})
    commits4 = Table({"lang": [commits["lang"][i % 32] for i in range(64)],
                      "status": ["ok" if i % 2 == 0 else "wip" for i in range(64)]})
    ok = [v for v, s in zip(commits4["lang"], commits4["status"]) if s == "ok"]
    n_pairs = sum(_block_key(a) == _block_key(b) for a in left["name"] for b in right["name"])
    n_distinct = len(set(commits["lang"]))
    return [
        ("Q1", Query(reviews, sess).llm_map("review", prompt=PROMPTS["summarize"],
                                            out_col="summary"),
         64, 64, ["review", "summary"], 64),
        ("Q2", Query(commits, sess).llm_correct("lang", prompt=PROMPTS["correct"]),
         64, 64, ["lang", "lang_fixed"], n_distinct),
        ("Q3", Query(left, sess).llm_join(right, ("name", "name"), prompt=PROMPTS["join"]),
         16 * 16, None, ["l_name", "r_name"], n_pairs),
        ("Q4", Query(commits4, sess).llm_correct("lang", prompt=PROMPTS["correct"], max_new=8)
         .filter(lambda r: r["status"] == "ok", columns=["status"]),
         64, len(ok), ["lang", "status", "lang_fixed"], len(set(ok))),
        ("Q5", Query(commits, sess, cascade="force").llm_correct(
            "lang", prompt=PROMPTS["correct"], accuracy_budget=0.25),
         64, 64, ["lang", "lang_fixed"], n_distinct),
    ]


def _engine_launches(engines):
    """K1 and K2 launches that the engines' steps and prefills must have
    made: every decode step runs K1 once a layer, every decode step and
    prefill of an int8 instance K2 once a linear."""
    k1 = sum(e["n_layers"] * e["stats"].decode_steps for e in engines)
    k2 = sum(7 * e["n_layers"] * (e["stats"].decode_steps + e["stats"].prefills)
             for e in engines if e["version"] != "base")
    return k1, k2


def olap_session(base, cfg):
    """A query's main path: an ``IOLMSession`` over the model (at its
    published widths, cut in depth by the caller) runs Q1-Q5 through ``Query.run``, each LLM operator calibrating on its
    own rows, searching three recipes (two of them pruned) and serving
    the picked instance through ``Engine`` on the card.  The grid's own
    ``w8-ffn75`` (GPTQ) is applied once on Q1's calibration statistics,
    after Q1 and outside its time.  The launch counts are zeroed just before Q1 and read just
    after Q5."""
    import gc
    from repro_torch.core.compressed import QTensor
    from repro_torch.kernels import ops
    from repro_torch.olap.query import IOLMSession

    grid, recipes = session_recipes(cfg)
    gptq, first = {}, []

    def gptq_once(optimizer):
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        params, cfg2, report = optimizer.apply(grid["w8-ffn75"])
        sync()
        linears = [w for blk in params["blocks"] for sub in ("attn", "mlp")
                   for w in blk[sub].values()]
        gptq.update(recipe="w8-ffn75", seconds=time.time() - t0, d_ff=cfg2.d_ff,
                    peak_memory=torch.cuda.max_memory_allocated(),
                    param_bytes=report.bytes_after,
                    all_quantized=all(isinstance(w, QTensor) for w in linears))
        check(cfg2.d_ff == 6912 and gptq["all_quantized"], ("grid w8-ffn75", gptq))

    sess = IOLMSession(base, cfg, device="cuda", recipes=recipes, **SESSION_KW)
    results, peak = [], 0
    ops.reset_launch_counts()
    def keep_first(optimizer):          # Q1's optimizer, until its GPTQ step
        if not first and not gptq:
            first.append(optimizer)

    with SessionProbe(on_search=keep_first) as probe:
        for name, q, n_in, n_out, cols, n_inv in olap_queries(sess):
            if name == "Q4":
                explain = q.explain()
                print(f"Q4 EXPLAIN:\n{explain}", flush=True)
            steps = [ln for ln in q.explain().splitlines() if " llm " in ln]
            check(steps and all(" backend=cuda " in ln for ln in steps), (name, steps))
            n_search, n_eng = len(probe.searches), len(probe.engines)
            before = dict(ops.variant_count)
            sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            out = q.run()
            sync()
            wall = time.time() - t0
            peak = max(peak, torch.cuda.max_memory_allocated())
            searches, engines = probe.searches[n_search:], probe.engines[n_eng:]
            delta = variant_delta(before)
            in_search = {}
            for s in searches:
                for k, n in s["variants"].items():
                    in_search[k] = in_search.get(k, 0) + n
            served = {k: n - in_search.get(k, 0) for k, n in delta.items()
                      if n - in_search.get(k, 0)}
            stats = q.last_run_stats
            rec = {"query": name, "rows_in": n_in, "rows_out": len(out), "wall_s": wall,
                   "rows_per_s": n_in / wall, "columns": list(out.columns),
                   "invocations": sum(s.invocations for s in stats),
                   "engine": stats[0].engine, "escalated": stats[0].escalated,
                   "threshold": stats[0].threshold, "searches": searches,
                   "engines": [{"version": e["version"], "decode_steps": e["stats"].decode_steps,
                                "prefills": e["stats"].prefills, "rows": e["stats"].rows,
                                "truncated": e["stats"].truncated,
                                "prefix_hits": e["stats"].prefix_hits,
                                "backend": e["stats"].backend} for e in engines],
                   "served_variants": served, "search_variants": in_search,
                   "peak_memory": torch.cuda.max_memory_allocated(),
                   "recalibrations": sess.recalibrations, "cascade_fits": sess.cascade_fits}
            results.append(rec)
            print(f"{name}: {len(out)} rows out of {n_in} in {wall:.2f} s "
                  f"({n_in / wall:.2f} rows/s), {rec['invocations']} invocations, engine "
                  f"{rec['engine']}, peak memory {rec['peak_memory']}" + "".join(
                      f", picked {s['picked']} (search {s['seconds']:.2f} s)" for s in searches),
                  flush=True)
            # the query's result
            check(list(out.columns) == cols and (n_out is None or len(out) == n_out),
                  (name, "rows or columns", len(out), list(out.columns)))
            check(rec["invocations"] == n_inv, (name, "invocations", rec["invocations"], n_inv))
            if name == "Q3":
                check(len(out) <= n_inv, ("Q3 matches", len(out), n_inv))
            # each search built and evaluated all three candidates
            for s in searches:
                check([c["recipe"] for c in s["candidates"]] == [r.name for r in recipes],
                      (name, "candidates", s["candidates"]))
                by = {c["recipe"]: c for c in s["candidates"]}
                check(by["w8a-ffn75"]["d_ff"] == 6912 and by["w8a-kv50"]["n_kv_heads"] == 2
                      and by["w8a-kv50"]["n_heads"] == 4, (name, "pruned cfgs", by))
                k2 = sum(7 * c["n_layers"] * SEARCH_MAX_NEW for c in s["candidates"])
                check(s["variants"].get("quant_matmul.mma") == sum(
                          7 * c["n_layers"] for c in s["candidates"])
                      and s["variants"].get("quant_matmul.decode", 0)
                      + s["variants"]["quant_matmul.mma"] == k2
                      and set(s["variants"]) == {"quant_matmul.decode", "quant_matmul.mma"},
                      (name, "search launches", s["variants"], k2))
            check(len(searches) == (0 if name == "Q5" else 1), (name, "searches", len(searches)))
            # every engine's K1, and K2 on the int8 ones, on their bf16 designs
            k1, k2 = _engine_launches(engines)
            check(k1 > 0 and served.get("paged_attention.split") == k1
                  and served.get("quant_matmul.decode", 0) + served.get("quant_matmul.mma", 0)
                  == k2 and served.get("quant_matmul.mma", 0) > 0
                  and served.get("quant_matmul.decode", 0) > 0
                  and set(served) <= {"paged_attention.split", "quant_matmul.decode",
                                      "quant_matmul.mma"},
                  (name, "served launches", served, k1, k2))
            check(all(e["stats"].backend == "cuda" for e in engines), (name, "engine backend"))
            if name == "Q1":          # the grid's GPTQ recipe on Q1's statistics
                gptq_once(first.pop())
                peak = max(peak, gptq["peak_memory"])
            del out, q
            gc.collect()
            torch.cuda.empty_cache()
    launches = dict(ops.launch_count)
    variants = {k: n for k, n in ops.variant_count.items() if n}
    check(results[3]["recalibrations"] == 4 and results[4]["recalibrations"] == 4
          and sess.cascade_fits == 1 and sess.model_cache.hits >= 1,
          ("model cache", [r["recalibrations"] for r in results], sess.cascade_fits))
    check(results[4]["engine"] == "cascade", ("Q5 engine", results[4]["engine"]))
    for m in sess.model_cache._d.values():
        check(all(w.q.is_cuda for blk in m.params["blocks"] for sub in ("attn", "mlp")
                  for w in blk[sub].values()), ("cached instance off the card", m.version))
    line = {"phase": "olap_session", "model": cfg.name, "layers": cfg.n_layers,
            "recipes": [r.name for r in recipes], "session": {
                k: v for k, v in SESSION_KW.items() if k != "engine_kw"},
            "engine_kw": SESSION_KW["engine_kw"],
            "calibrations": probe.calibrations, "applies": probe.applies,
            "gptq_w8_ffn75": gptq, "queries": results, "launches": launches,
            "variants": variants, "recalibrations": sess.recalibrations,
            "cascade_fits": sess.cascade_fits, "model_cache_hits": sess.model_cache.hits,
            "log": sess.log, "max_memory_allocated": peak}
    emit(line)
    for c in probe.calibrations:
        print(f"calibrate {c['tokens']} tokens: {c['seconds']:.2f} s", flush=True)
    for s in (s for r in results for s in r["searches"]):
        print("search " + ", ".join(
            f"{c['recipe']} {c['eval_rows_per_s']:.2f} rows/s {c['param_bytes']} B"
            for c in s["candidates"]) + f"; picked {s['picked']} in {s['seconds']:.2f} s",
            flush=True)
    print("apply s: " + ", ".join(f"{a['recipe']} {a['seconds']:.2f}" for a in probe.applies),
          flush=True)
    print(f"w8-ffn75 (GPTQ) on Q1's statistics: {gptq['seconds']:.2f} s, peak memory "
          f"{gptq['peak_memory']}", flush=True)
    print(f"olap_session max_memory_allocated: {line['max_memory_allocated']}", flush=True)
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches, variants


NEAR_TIE = 1e-4                 # top-two logit gap under which f32 argmaxes may flip


def olap_f32_parity(gen, cfg_full, layers: int = 4, name="olap_f32_parity"):
    """Q2 at ``cfg_full``'s widths (gemma2-2b's, qwen2-moe-a2.7b's,
    zamba2-7b's or rwkv6-3b's) in f32 at ``layers`` layers, with
    ``recipes=[w8-absmax]``, run by one session on the cuda backend and by
    one on the reference backend.  The tables must be identical; a row
    whose tokens differ must be a near tie: the plain instance's top-two
    logit gap at the first differing token under NEAR_TIE.  The cuda side
    runs K2's FMA design, K1 where the family serves paged KV (not rwkv),
    and K2 over experts on the FMA design for an MoE model; the reference
    side nothing."""
    import gc
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.olap.query import IOLMSession, Query
    from repro_torch.olap.table import Table
    from repro_torch.training.data import PROMPTS, ByteTokenizer, workload_rows

    cfg = cfg_full.replace(n_layers=layers, param_dtype="float32",
                           attn_pattern=cfg_full.attn_pattern and "LG" * (layers // 2))
    params = api.init_params(gen, cfg)
    grid, _ = session_recipes(cfg)
    commits = Table({"lang": [r.text for r in workload_rows("correct", 64)]})
    runs = {}
    for backend in ("cuda", "reference"):
        ops.reset_launch_counts()
        with SessionProbe(ids=True) as probe:
            sess = IOLMSession(params, cfg, device="cuda", backend=backend,
                               recipes=[grid["w8-absmax"]], **SESSION_KW)
            q = Query(commits, sess).llm_correct("lang", prompt=PROMPTS["correct"])
            steps = [ln for ln in q.explain().splitlines() if " llm " in ln]
            check(steps and all(f" backend={backend} " in ln for ln in steps), steps)
            sync()
            t0 = time.time()
            out = q.run()
            sync()
        variants = {k: n for k, n in ops.variant_count.items() if n}
        if backend == "cuda":
            want = {"quant_matmul.fma"}
            if api.supports_paged(cfg):
                G = cfg.n_heads // cfg.n_kv_heads
                want.add(f"paged_attention.{ops.paged_attention_variant(torch.float32, G)}")
            if cfg.family == "moe":
                want.add("quant_matmul.expert_fma")
            check(set(variants) == want, ("f32 session designs", variants))
        else:
            check(not variants, ("reference session launched kernels", variants))
        runs[backend] = {"table": out, "ids": probe.ids, "wall_s": time.time() - t0,
                         "variants": variants, "model": next(iter(sess.model_cache._d.values())),
                         "search": probe.searches}
        del sess, q
    tok = ByteTokenizer(max(cfg.vocab_size, 260))
    c, r = runs["cuda"], runs["reference"]
    differ = []
    for text in sorted(r["ids"]):
        a, b = c["ids"].get(text), r["ids"][text]
        if a == b:
            continue
        j = next(i for i in range(min(len(a), len(b)) + 1)
                 if i == min(len(a), len(b)) or a[i] != b[i])
        ids = tok.encode(text, bos=True) + [tok.SEP] + b[:j]
        m = r["model"]
        with kernel_backend("reference"), torch.no_grad():
            lg, _ = api.forward(m.params, m.cfg, {"tokens": torch.tensor([ids], device="cuda")})
        top = lg[0, -1].float().topk(2).values
        differ.append({"prompt": text, "token": j, "gap": (top[0] - top[1]).item()})
    same_table = c["table"].columns == r["table"].columns
    line = {"phase": name, "model": cfg.name, "layers": layers,
            "dtype": "float32", "recipe": "w8-absmax", "rows": 64,
            "distinct_prompts": len(r["ids"]), "tables_identical": same_table,
            "rows_with_other_tokens": differ, "near_tie_bound": NEAR_TIE,
            "wall_s": {k: v["wall_s"] for k, v in runs.items()},
            "variants": {k: v["variants"] for k, v in runs.items()}}
    emit(line)
    print(f"{name}: tables identical {same_table}, {len(differ)} of "
          f"{len(r['ids'])} prompts with other tokens"
          + "".join(f", gap {d['gap']:.2e} at token {d['token']}" for d in differ), flush=True)
    check(sorted(c["ids"]) == sorted(r["ids"]), "the two sessions served other prompts")
    check(all(d["gap"] < NEAR_TIE for d in differ), line)
    check(same_table or differ, line)
    del runs, params
    gc.collect()
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------------------
# phases olap_pool_*: several tenants' queries through one byte-budgeted
# ModelPool and one fair-share Scheduler
# ---------------------------------------------------------------------------

POOL_KW = SESSION_KW["engine_kw"]
POOL_ENTRIES = 2.8        # the pool budget in base entries: 2 base or 3 w8-absmax engines
# the pooled phases and service_full_width run gemma2-2b cut to its first
# POOL_LAYERS layers (the same weights, the published widths), which keeps
# the script within its time as paths are added
POOL_LAYERS = 8
# the session phases run the first layers of their bases in the same way
# (cut as phases were added, to keep the script within its 1200 s limit on
# the slower hosts, within 1100 s on the others): gemma2-2b 8 of 26, qwen2-moe-a2.7b 4 of
# 24, zamba2-7b 2 of its 11 groups (14 of 81 block applications), rwkv6-3b
# 8 of 32, paligemma-3b 6 of 18
SESSION_LAYERS = {"gemma2-2b": 8, "qwen2-moe-a2.7b": 4, "zamba2-7b": 14, "rwkv6-3b": 8,
                  "paligemma-3b": 6}
FLEET_ROWS, FLEET_MAX_NEW, FLEET_TENANTS = 16, 8, (1, 4)
POOL_SHARE = 8            # in-flight rows per submission


def card_memory():
    """(memory_allocated, max_memory_allocated) of the card; zeros off it."""
    if not torch.cuda.is_available():
        return 0, 0
    return torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()


def reset_peak() -> None:
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def _first(tree, k: int):
    """The first ``k`` entries of every leaf of a stacked subtree (views)."""
    return {n: _first(v, k) for n, v in tree.items()} if isinstance(tree, dict) else tree[:k]


def cut_depth(params, cfg, layers: int = POOL_LAYERS):
    """The first ``layers`` layers of a stacked model (whole pattern units;
    for the hybrid whole groups of Mamba layers and the shared block, and
    no Mamba tail), views of the same weights, and its config."""
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        G, K, _, _ = hybrid.layout(cfg)
        g = layers // (K + 1)
        check(g * (K + 1) == layers and g <= G, ("depth cut", cfg.name, layers))
        cut = {**params, "mamba_groups": _first(params["mamba_groups"], g), "mamba_tail": None}
        return cut, cfg.replace(n_layers=layers)
    from repro_torch.models.transformer import pattern_unit
    unit, R, tail = pattern_unit(cfg)
    k = layers // len(unit)
    check(k * len(unit) == layers and k <= R and not tail, ("depth cut", cfg.name, layers))
    cut = {**params, "blocks": [_first(b, k) for b in params["blocks"]], "tail": []}
    return cut, cfg.replace(n_layers=layers, attn_pattern=cfg.attn_pattern and unit * k)


def pool_budget(params, cfg, engine_kw):
    """(bytes of one base entry, the pool budget): the pool charges an
    entry ``param_bytes + slots * slot_state_bytes(cfg, max_len)``."""
    from repro_torch.core.compressed import param_bytes
    from repro_torch.serving.scheduler import slot_state_bytes
    entry = param_bytes(params) + engine_kw["slots"] * slot_state_bytes(cfg, engine_kw["max_len"])
    return entry, int(POOL_ENTRIES * entry)


def tenant_workload(i: int, n_rows: int, *, seed0: int = 100):
    """Tenant ``i``'s template and prompts: the data-correction workload
    behind a template of its own, so each tenant has its own query
    signature and instance; unique row suffixes keep the result cache out
    of the measurement (a copy of ``benchmarks/common.py``'s)."""
    from repro_torch.training.data import workload_rows
    tmpl = (f"tenant-{i} data cleaning: reply with only the canonical "
            f"category for value: ")
    rows = workload_rows("correct", n_rows, seed=seed0 + i)
    return tmpl, [f"{tmpl}{r.text}#{j}" for j, r in enumerate(rows)]


NEAR_TIE_SIGMAS = 4       # bf16: near tie within this many standard deviations


def tie_at(params, cfg, tok, prompt, a, b, top, p32=None, noisy=None):
    """Where two runs' token ids ``a`` and ``b`` for ``prompt`` part, and
    whether that is a near tie.  The plain path (reference backend) runs
    the prompt as the engine saw it (clipped to the top bucket ``top``
    from the left) and the shared tokens.  In f32 the criterion is
    olap_f32_parity's: the top-two logit gap under NEAR_TIE.  In bf16 the
    gap of the two tokens ``x`` and ``y`` on the f32 path (the same
    weights, ``p32`` = ``_f32(params)``, with f32 activations) is held to
    the noise of one bf16 run's logit difference: with ``sigma`` the RMS
    of the bf16 path's logit error over the vocabulary at that position,
    a difference of two logits carries sqrt(2) sigma, and two bf16 runs
    can order ``x`` and ``y`` either way only if the gap is within
    NEAR_TIE_SIGMAS of that.  ``noisy``: the params whose bf16 path gives
    ``sigma`` when they are not ``params`` (another instance of the same
    model, whose own error then counts in ``sigma``)."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.models import api
    n = min(len(a), len(b))
    j = next((i for i in range(n) if a[i] != b[i]), n)
    x = a[j] if j < len(a) else tok.EOS
    y = b[j] if j < len(b) else tok.EOS
    ids = (tok.encode(prompt, bos=True) + [tok.SEP])[-top:] + a[:j]
    toks = torch.tensor([ids], device=params["embed"].device)
    with kernel_backend("reference"), torch.no_grad():
        lg = api.forward(params if noisy is None else noisy, cfg,
                         {"tokens": toks})[0][0, -1].float()
        if cfg.dtype == torch.float32:
            top2 = lg.topk(2).values
            gap = (top2[0] - top2[1]).item()
            return {"token": j, "gap": gap, "bound": NEAR_TIE, "near_tie": gap < NEAR_TIE}
        lg32 = api.forward(p32 if p32 is not None else _f32(params),
                           cfg.replace(param_dtype="float32"),
                           {"tokens": toks})[0][0, -1].float()
    gap = abs(lg32[x] - lg32[y]).item()
    sigma = (lg - lg32).pow(2).mean().sqrt().item()
    bound = NEAR_TIE_SIGMAS * math.sqrt(2) * sigma
    return {"token": j, "gap": gap, "sigma": sigma, "bound": bound, "near_tie": gap <= bound}


def _p32_of(p32, models, version):
    """The f32 copy of ``version``'s params for ``tie_at``, one at a time."""
    params, cfg = models[version]
    if cfg.dtype != torch.float32 and version not in p32:
        p32.clear()
        p32[version] = _f32(params)
    return p32.get(version)


def parted_rows(scheduled, serial, models, tok, top, skip=()):
    """Every (model version, prompt) the serial run served whose token ids
    the scheduled run did not reproduce, with ``tie_at``'s verdict.  The
    scheduled run must have served every such row on the same model,
    but for the keys in ``skip``."""
    out, p32 = [], {}
    for key in sorted(set(serial) - set(skip)):
        a, b = scheduled.get(key), serial[key]
        check(a is not None, ("the scheduled run never served", key))
        if a != b:
            params, cfg = models[key[0]]
            out.append({"version": key[0], "prompt": key[1],
                        **tie_at(params, cfg, tok, key[1], a, b, top,
                                 _p32_of(p32, models, key[0]))})
    return out


def control_rows(serial, models, tok, top):
    """The near-tie criterion on rows known to be wrong: for each model
    version of the serial run, its first row (by prompt) is given the
    token ids of the first row of another version whose first token
    differs, as a fault that served one tenant's row to another would.
    Each must come out not a near tie."""
    keys, out, p32 = sorted(serial), [], {}
    for version in sorted({v for v, _ in keys}):
        key = next(k for k in keys if k[0] == version)
        donor = next((k for k in keys if k[0] != version and serial[k][:1] != serial[key][:1]),
                     None)
        if donor is None:
            continue
        params, cfg = models[version]
        out.append({"version": version, "prompt": key[1], "donor": list(donor),
                    **tie_at(params, cfg, tok, key[1], serial[donor], serial[key], top,
                             _p32_of(p32, models, version))})
    return out


LLM_OUT = ("summary", "lang_fixed")      # the columns the queries' LLM steps write


def unexplained_rows(got, want, allowed):
    """Rows in which table ``got`` differs from ``want``, in row order,
    whose input values (every column but LLM_OUT) do not all appear in one
    prompt of ``allowed``: the prompts whose token ids parted between the
    runs or that escalated in one run only.  A row spliced out of order,
    or one whose tokens were equal, is unexplained."""
    import difflib
    cols = list(want.columns)
    if list(got.columns) != cols:
        return [("columns", list(got.columns), cols)]
    rows = [list(zip(*(t[c] for c in cols))) for t in (got, want)]
    ins = [i for i, c in enumerate(cols) if c not in LLM_OUT]
    out = []
    sm = difflib.SequenceMatcher(None, rows[0], rows[1], autojunk=False)
    for op, i0, i1, j0, j1 in sm.get_opcodes():
        if op != "equal":
            for r in rows[0][i0:i1] + rows[1][j0:j1]:
                if not any(all(str(r[i]) in p for i in ins) for p in allowed):
                    out.append(r)
    return out


def emit_pool_line(line, served):
    """Print a pool phase's line with its parted rows summarised (the whole
    record goes to chiprun_out/chip_smoke.json)."""
    emit({**{k: v for k, v in line.items() if k not in ("parted_rows", "log", "controls")},
          "parted": parted_summary(line["parted_rows"], served)})


def parted_summary(parted, served):
    """The compact form of ``parted_rows`` for a phase's printed line."""
    by = {}
    for p in parted:
        by[p["version"]] = by.get(p["version"], 0) + 1
    return {"rows_compared": served, "parted": len(parted), "by_version": by,
            "max_gap": max((p["gap"] for p in parted), default=None),
            "min_bound": min((p["bound"] for p in parted), default=None),
            "max_gap_over_bound": max((p["gap"] / p["bound"] for p in parted), default=None)}


def _models_of(sess):
    """version -> (params, cfg) of the base and of every cached instance."""
    models = {"base": (sess.params, sess.cfg)}
    for m in sess.model_cache._d.values():
        models[m.version] = (m.params, m.cfg)
    return models


def _no_degradation(sched, what):
    check(sched.stats.degradations == 0 and sched.stats.events == [],
          (what, "degraded", sched.stats.degradations, sched.stats.events))


def _tenant_lines(sched):
    return {t: {"rows": ts.rows, "queue_wait_p50_s": ts.queue_wait.quantile(0.5),
                "queue_wait_p95_s": ts.queue_wait.quantile(0.95),
                "latency_p50_s": ts.latency.quantile(0.5),
                "latency_p95_s": ts.latency.quantile(0.95)}
            for t, ts in sched.stats.tenants.items()}


def olap_pool_fleet(base, cfg, device="cuda"):
    """The full-width counterpart of ``benchmarks/multi_tenant.py``.  Each
    tenant runs the data-correction workload behind its own template (its
    own qsig, so its own instance) through one ``ModelPool`` and one
    ``Scheduler``.  Two fleets under the same budget of POOL_ENTRIES base
    entries: ``base`` (the identity recipe: one full-size instance per
    tenant) and ``iolm`` (``w8-absmax``), each recipe pinned.  For 1 and 4
    tenants a fleet first builds its tenants' instances (the session's
    model cache keeps them), then serves every tenant once through a new
    pool: engines are admitted, evicted and rebuilt inside the timed pass,
    the instances are not.  (The reference benchmark's warm pass, a first
    pass that also builds, is left out to keep the run short.)  The launch
    counts are zeroed just before the pass and read just after.  Gates:
    every row returned, the budget never exceeded, more resident ``iolm``
    than ``base`` models at 4 tenants, each tenant's rows equal to a
    private serial engine on the same model (rows parted at a near tie
    counted), K1 and K2 launched in every ``iolm`` pass, no degradation."""
    import gc
    from repro_torch.core.pipeline import Recipe
    from repro_torch.kernels import ops
    from repro_torch.olap.query import IOLMSession
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import ModelPool, Scheduler

    on_card = torch.device(device).type == "cuda"
    grid, _ = session_recipes(cfg)
    fleets = {"base": Recipe(name="identity"), "iolm": grid["w8-absmax"]}
    entry, budget = pool_budget(base, cfg, POOL_KW)
    cells, launches, parted = [], {}, []
    for fleet, recipe in fleets.items():
        sess = IOLMSession(base, cfg, device=device, recipes=[recipe], calib_rows=8,
                           eval_rows=4, engine_kw=dict(POOL_KW))
        for n in FLEET_TENANTS:
            work = [tenant_workload(i, FLEET_ROWS) for i in range(n)]
            rec0 = sess.recalibrations
            sync()
            reset_peak()
            t0 = time.time()
            for i, (_, prompts) in enumerate(work):      # the pool resolves these again
                sess._optimize(f"t{i}", prompts[:12])
            sync()
            build_s, build_peak = time.time() - t0, card_memory()[1]
            sess.pool = pool = ModelPool(sess, budget, engine_kw=sess.engine_kw)
            sched = Scheduler(pool, share=POOL_SHARE)
            ops.reset_launch_counts()
            reset_peak()
            t0 = time.time()
            subs = [sched.submit(f"t{i}", prompts, qsig=f"t{i}", probe=prompts[:12],
                                 max_new=FLEET_MAX_NEW, prefix=tmpl)
                    for i, (tmpl, prompts) in enumerate(work)]
            sched.run()
            sync()
            wall = time.time() - t0
            got = dict(ops.launch_count)
            variants = {k: v for k, v in ops.variant_count.items() if v}
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            alloc, peak = card_memory()
            rows = sum(len(s.results()) for s in subs)
            cell = {"fleet": fleet, "tenants": n, "rows": rows, "wall_s": wall,
                    "rows_per_s": rows / wall, "builds": sess.recalibrations - rec0,
                    "build_s": build_s, "build_peak_memory": build_peak,
                    "resident_models": len(pool),
                    "peak_resident_models": pool.stats.peak_resident_models,
                    "resident_bytes": pool.resident_bytes,
                    "peak_resident_bytes": pool.stats.peak_resident_bytes,
                    "budget": budget, "memory_allocated": alloc, "peak_memory": peak,
                    "evictions": pool.stats.evictions,
                    "eviction_log": list(pool.eviction_log), "ticks": sched.stats.ticks,
                    "tenants_stats": _tenant_lines(sched),
                    "launches": got, "variants": variants,
                    "truncated": sum(e.engine.stats.truncated for e in pool._entries.values())}
            cells.append(cell)
            print(f"olap_pool_fleet {fleet} {n} tenant(s): {cell['rows_per_s']:.2f} rows/s "
                  f"({rows} rows in {wall:.2f} s; {cell['builds']} builds before it in "
                  f"{build_s:.2f} s, peak {build_peak}), {cell['resident_models']} resident "
                  f"(peak {cell['peak_resident_models']}), pool {pool.resident_bytes} B "
                  f"of {budget} vs memory_allocated {alloc}, {cell['evictions']} "
                  f"evictions, {sched.stats.ticks} ticks, peak memory {peak}; "
                  + "; ".join(f"{t}: wait p50 {v['queue_wait_p50_s']:.3f} s "
                              f"p95 {v['queue_wait_p95_s']:.3f} s, row p50 "
                              f"{v['latency_p50_s']:.3f} s p95 {v['latency_p95_s']:.3f} s"
                              for t, v in cell["tenants_stats"].items()), flush=True)
            check(rows == n * FLEET_ROWS
                  and all(len(s.results()) == FLEET_ROWS for s in subs), (fleet, n, "rows"))
            check(pool.stats.peak_resident_bytes <= budget, (fleet, n, "over budget", cell))
            _no_degradation(sched, (fleet, n))
            if on_card:
                check(got["paged_attention"] > 0 and got["flash_attention"] == 0
                      and got["block_sparse_matmul"] == 0
                      and (got["quant_matmul"] > 0) == (fleet == "iolm"),
                      (fleet, n, "launches", got))
            if n == FLEET_TENANTS[-1]:
                # each tenant against a private engine on its own model, served alone
                tok = sess.tok
                for sub, (tmpl, prompts) in zip(subs, work):
                    m = sess._optimize(sub.qsig, sub.probe)           # a model-cache hit
                    eng = Engine(m.params, m.cfg, tokenizer=tok, version=m.version,
                                 **sess.engine_kw)
                    ref = eng.generate_stream(iter(prompts), max_new=FLEET_MAX_NEW,
                                              prefix=tmpl, return_requests=True)
                    for p, r, s in zip(prompts, ref, sub.reqs):
                        if r.out_ids != s.out_ids:
                            parted.append({"fleet": fleet, "tenant": sub.tenant, "prompt": p,
                                           **tie_at(m.params, m.cfg, tok, p, s.out_ids,
                                                    r.out_ids, POOL_KW["buckets"][-1])})
                    del eng
        del sess, pool
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    by = {(c["fleet"], c["tenants"]): c for c in cells}
    n = FLEET_TENANTS[-1]
    line = {"phase": "olap_pool_fleet", "model": cfg.name, "layers": cfg.n_layers,
            "engine_kw": POOL_KW, "share": POOL_SHARE, "rows_per_tenant": FLEET_ROWS,
            "max_new": FLEET_MAX_NEW, "base_entry_bytes": entry, "budget": budget,
            "budget_entries": POOL_ENTRIES, "cells": cells, "parted_rows": parted,
            "near_ties": len(parted), "launches": launches}
    emit_pool_line(line, 2 * FLEET_ROWS * FLEET_TENANTS[-1])
    print(f"olap_pool_fleet: budget {budget} B ({POOL_ENTRIES} base entries of {entry} B); "
          f"peak resident models at {n} tenants: base {by['base', n]['peak_resident_models']}, "
          f"iolm {by['iolm', n]['peak_resident_models']}; {len(parted)} rows parted "
          "from the serial run" + "".join(f", {p['tenant']} gap {p['gap']:.3g} bound "
                                          f"{p['bound']:.3g}" for p in parted), flush=True)
    check(by["iolm", n]["peak_resident_models"] > by["base", n]["peak_resident_models"],
          ("resident models", by))
    check(all(p["near_tie"] for p in parted), ("fleet rows parted from serial", parted))
    return line, launches


def olap_pool_session(base, cfg, device="cuda"):
    """``olap_session``'s queries as five tenants of one pooled session:
    an ``IOLMSession(pool_budget=POOL_ENTRIES base entries)`` over the
    bf16 base with the same three absmax recipes runs Q1-Q4 and Q5 (Q2 as
    a forced cascade at budget 0.25) through ``Scheduler(sess.pool,
    share=POOL_SHARE).run_queries``, Q5 first so its cascade fit finds the
    pool empty.  The launch counts are zeroed just before
    ``run_queries`` and read just after.  The same queries then run
    serially through ``Query.run`` on a session without a pool that shares
    the pooled session's model cache and cascade thresholds (no rebuild,
    no refit): private engines with fresh result caches.  Gates: each
    query's rows and columns as ``olap_session`` checks them; each
    query's table equal to the serial one row by row, in order, but rows
    whose prompt parted at a near tie or escalated in one run only
    (``unexplained_rows``); every ``control_rows`` reading not a near tie;
    Q5 escalating in each run
    exactly its rows under the fitted threshold and the two runs
    escalating the same rows but those whose confidence moved between
    them (counted), proxy and base resident together at Q5's cascade
    fit, ``placement: pool`` in every EXPLAIN, K1 and K2 launched, no
    degradation."""
    import dataclasses
    import gc
    from repro_torch.kernels import ops
    from repro_torch.olap.query import IOLMSession
    from repro_torch.serving.scheduler import Scheduler

    on_card = torch.device(device).type == "cuda"
    _, recipes = session_recipes(cfg)
    entry, budget = pool_budget(base, cfg, SESSION_KW["engine_kw"])
    sess = IOLMSession(base, cfg, device=device, recipes=recipes, pool_budget=budget,
                       **SESSION_KW)
    queries = olap_queries(sess)
    queries = queries[4:] + queries[:4]              # Q5 first
    builds, fit, peak = [], {}, [0]
    real_optimize, real_cascade = sess._optimize, sess._cascade

    def optimize(qsig, prompts):
        n0 = sess.recalibrations
        sync()
        peak[0] = max(peak[0], card_memory()[1])
        reset_peak()
        t0 = time.time()
        m = real_optimize(qsig, prompts)
        sync()
        if sess.recalibrations > n0:
            alloc, top = card_memory()
            builds.append({"qsig": qsig, "recipe": m.recipe.name, "seconds": time.time() - t0,
                           "peak_memory": top, "memory_after": alloc,
                           "resident_models": len(sess.pool),
                           "resident_bytes": sess.pool.resident_bytes})
        return m

    def cascade(qsig, prompts, budget, **kw):
        cal = real_cascade(qsig, prompts, budget, **kw)
        fit.setdefault("resident_after_fit", list(sess.pool.resident_versions))
        return cal

    sess._optimize, sess._cascade = optimize, cascade
    for name, q, *_ in queries:
        txt = q.explain()
        steps = [ln for ln in txt.splitlines() if " llm " in ln]
        check("placement: pool," in txt and steps
              and all(" placement=pool " in ln and (" backend=cuda " in ln or not on_card)
                      for ln in steps), (name, "EXPLAIN", txt))
    sched = Scheduler(sess.pool, share=POOL_SHARE)
    real_step, ticks = sched.step, []

    def step():
        more = real_step()
        if any(s.tenant == "Q5" for s in sched.active):
            ticks.append(set(sess.pool.resident_versions))
        return more

    sched.step = step
    ops.reset_launch_counts()
    with SessionProbe(ids=True) as probe:
        sync()
        t0 = time.time()
        tables = sched.run_queries({name: q for name, q, *_ in queries})
        sync()
        wall = time.time() - t0
    launches = dict(ops.launch_count)
    variants = {k: v for k, v in ops.variant_count.items() if v}
    peak[0] = max(peak[0], card_memory()[1])
    _no_degradation(sched, "olap_pool_session")
    subs = {}
    for s in sched.finished:
        subs.setdefault(s.tenant, []).append(s)
    proxy = next(s.engine.version for s in subs["Q5"] if s.optimize)
    results = {}
    for name, q, n_in, n_out, cols, n_inv in queries:
        out = tables[name]
        inv = sum(len(s.reqs) for s in subs[name] if s.optimize)
        results[name] = {"rows_in": n_in, "rows_out": len(out), "columns": list(out.columns),
                         "invocations": inv,
                         "escalated": sum(len(s.reqs) for s in subs[name] if not s.optimize)}
        check(list(out.columns) == cols and (n_out is None or len(out) == n_out),
              (name, "rows or columns", len(out), list(out.columns)))
        check(inv == n_inv, (name, "invocations", inv, n_inv))
    pooled_engines = [{"version": e["version"], "truncated": e["stats"].truncated,
                       "rows": e["stats"].rows, "decode_steps": e["stats"].decode_steps,
                       "prefills": e["stats"].prefills, "cache_hits": e["stats"].cache_hits}
                      for e in probe.engines]
    scheduled_ids = dict(probe.vids)

    # the serial reference: the same built models on private engines
    serial = IOLMSession(base, cfg, device=device, recipes=recipes, **SESSION_KW)
    serial.model_cache, serial.cascade_cache = sess.model_cache, sess.cascade_cache
    serial_tables, escalated = {}, {}
    with SessionProbe(ids=True) as sprobe:
        sync()
        t0 = time.time()
        for name, q, *_ in olap_queries(serial):
            serial_tables[name] = q.run()
            escalated[name] = q.last_run_stats[0].escalated
        sync()
        serial_wall = time.time() - t0
    check(serial.recalibrations == 0 and serial.cascade_fits == 0,
          ("the serial run rebuilt", serial.recalibrations, serial.cascade_fits))
    # Q5's escalations.  In each run a row escalates exactly when its proxy
    # confidence is under the one fitted threshold.  A bf16 confidence moves
    # with the prefill's batch shape, so the two runs may escalate other
    # rows; such a row must be one whose confidence moved across the
    # threshold between the runs (counted), never one whose confidence is
    # the same in both.
    (cal,) = sess.cascade_cache.values()
    thr = cal.threshold
    proxy_sub = next(s for s in subs["Q5"] if s.optimize)
    sched_conf = {r.src: r.confidence for r in proxy_sub.reqs}
    sched_esc = {r.src for s in subs["Q5"] if not s.optimize for r in s.reqs}
    serial_conf = {src: c for (v, src), c in sprobe.vconf.items() if v == proxy}
    serial_esc = {src for v, src in sprobe.vids if v == "base"}
    check(sched_esc == {p for p, c in sched_conf.items() if c < thr},
          ("scheduled Q5 escalated other rows than its low-confidence ones", thr))
    check(len(serial_esc) == escalated["Q5"]
          and serial_esc == {p for p in sched_conf if serial_conf[p] < thr},
          ("serial Q5 escalations", len(serial_esc), escalated["Q5"]))
    crossed = [{"prompt": p, "scheduled_confidence": sched_conf[p],
                "serial_confidence": serial_conf[p], "threshold": thr,
                "proxy_tokens_equal": scheduled_ids.get((proxy, p)) == sprobe.vids.get((proxy, p))}
               for p in sorted(sched_esc ^ serial_esc)]
    models, top = _models_of(sess), SESSION_KW["engine_kw"]["buckets"][-1]
    parted = parted_rows(scheduled_ids, sprobe.vids, models, sess.tok, top,
                         skip={("base", c["prompt"]) for c in crossed})
    controls = control_rows(sprobe.vids, models, sess.tok, top)
    differ = [name for name in tables if tables[name].columns != serial_tables[name].columns]
    parted_keys = {(p["version"], p["prompt"]) for p in parted}
    unexplained = {}
    for name in tables:        # each query's rows against its own parted prompts
        allowed = {r.src for sub in subs[name] for r in sub.reqs
                   if (sub.engine.version, r.src) in parted_keys}
        if name == "Q5":
            allowed |= {c["prompt"] for c in crossed}
        unexplained[name] = unexplained_rows(tables[name], serial_tables[name], allowed)
    together = sum(proxy in r and "base" in r for r in ticks)
    line = {"phase": "olap_pool_session", "model": cfg.name, "layers": cfg.n_layers,
            "budget": budget, "base_entry_bytes": entry, "budget_entries": POOL_ENTRIES,
            "share": POOL_SHARE, "recipes": [r.name for r in recipes],
            "order": [name for name, *_ in queries], "queries": results,
            "scheduled_wall_s": wall, "serial_wall_s": serial_wall,
            "pool_stats": dataclasses.asdict(sess.pool.stats),
            "eviction_log": list(sess.pool.eviction_log),
            "resident_versions": sess.pool.resident_versions,
            "scheduler": sched.stats.as_dict(), "builds": builds,
            "proxy": proxy, "resident_after_cascade_fit": fit.get("resident_after_fit"),
            "q5_ticks": len(ticks), "q5_ticks_proxy_and_base_resident": together,
            "q5_threshold": thr, "q5_crossed": crossed,
            "engines": pooled_engines,
            "serial_engines": [{"version": e["version"], "truncated": e["stats"].truncated}
                               for e in sprobe.engines],
            "serial_escalated": escalated, "tables_differ": differ,
            "unexplained_rows": unexplained, "parted_rows": parted,
            "near_ties": len(parted), "controls": controls,
            "launches": launches, "variants": variants,
            "max_memory_allocated": peak[0], "log": sess.log}
    emit_pool_line(line, len(sprobe.vids))
    print(f"olap_pool_session: scheduled {wall:.2f} s, serial {serial_wall:.2f} s; pool "
          f"hits {sess.pool.stats.hits} misses {sess.pool.stats.misses} evictions "
          f"{sess.pool.stats.evictions} {sess.pool.eviction_log}, peak resident "
          f"{sess.pool.stats.peak_resident_models} models / "
          f"{sess.pool.stats.peak_resident_bytes} B of {budget}; Q5 escalated "
          f"{results['Q5']['escalated']} (serial {escalated['Q5']}, {len(crossed)} rows "
          f"crossed the threshold {thr:.4g} between the runs); {len(parted)} rows "
          f"parted from serial; designs {variants}", flush=True)
    print("controls (wrong rows, each must not be a near tie): " + ", ".join(
        f"{c['version'].split(':')[-1]} gap {c['gap']:.3g} bound {c['bound']:.3g} "
        f"near tie {c['near_tie']}" for c in controls), flush=True)
    for b in builds:
        print(f"build {b['qsig']}: {b['recipe']} in {b['seconds']:.2f} s, peak "
              f"{b['peak_memory']}, memory after {b['memory_after']}, pool "
              f"{b['resident_models']} models {b['resident_bytes']} B", flush=True)
    print("truncated per engine: " + ", ".join(
        f"{e['version'].split(':')[-1]} {e['truncated']}" for e in pooled_engines), flush=True)
    check(all(c["scheduled_confidence"] != c["serial_confidence"] for c in crossed),
          ("Q5 escalated", results["Q5"]["escalated"], escalated["Q5"], crossed))
    check(sess.pool.stats.peak_resident_bytes <= budget, ("over budget", line["pool_stats"]))
    check({proxy, "base"} <= set(fit.get("resident_after_fit", ())),
          ("proxy and base not resident together", fit, together))
    check(all(p["near_tie"] for p in parted), ("rows parted from serial", parted))
    check(controls and not any(c["near_tie"] for c in controls),
          ("a wrong row passed as a near tie", controls))
    check(not any(unexplained.values()), ("table rows differ unexplained", unexplained))
    if on_card:
        check(launches["paged_attention"] > 0 and launches["quant_matmul"] > 0
              and launches["flash_attention"] == 0 and launches["block_sparse_matmul"] == 0,
              ("olap_pool_session launches", launches))
    del sess, serial, tables, serial_tables, probe, sprobe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return line, launches


def olap_pool_f32_parity(gen, cfg_full, device="cuda", layers: int = 4):
    """Q1 and Q2 at gemma2-2b's widths in f32 at ``layers`` layers, as two
    tenants of a pooled cuda-backend session under ``run_queries``, against
    the same queries run serially by a reference-backend session without a
    pool.  Gates: identical tables, row by row in order, but rows whose
    prompt parted at a near tie (counted, as in olap_f32_parity), kernel
    launches on the cuda side only, no degradation."""
    import gc
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.olap.query import IOLMSession, Query
    from repro_torch.olap.table import Table
    from repro_torch.serving.scheduler import Scheduler
    from repro_torch.training.data import PROMPTS, workload_rows

    on_card = torch.device(device).type == "cuda"
    cfg = cfg_full.replace(n_layers=layers, attn_pattern="LG" * (layers // 2),
                           param_dtype="float32")
    params = api.init_params(gen, cfg)
    grid, _ = session_recipes(cfg)
    _, budget = pool_budget(params, cfg, SESSION_KW["engine_kw"])

    def queries(sess):
        reviews = Table({"review": [r.text for r in workload_rows("summarize", 64)]})
        commits = Table({"lang": [r.text for r in workload_rows("correct", 64)]})
        return {"Q1": Query(reviews, sess).llm_map("review", prompt=PROMPTS["summarize"],
                                                   out_col="summary"),
                "Q2": Query(commits, sess).llm_correct("lang", prompt=PROMPTS["correct"])}

    runs = {}
    for backend in ("cuda", "reference"):
        pooled = backend == "cuda"
        # (off the card, as when this phase is rehearsed on the host, both
        # sides run the plain path)
        sess = IOLMSession(params, cfg, device=device,
                           backend=backend if on_card else "reference",
                           recipes=[grid["w8-absmax"]], **SESSION_KW,
                           **(dict(pool_budget=budget) if pooled else {}))
        qs = queries(sess)
        ops.reset_launch_counts()
        with SessionProbe(ids=True) as probe:
            sync()
            t0 = time.time()
            served = {}
            if pooled:
                sched = Scheduler(sess.pool, share=POOL_SHARE)
                tables = sched.run_queries(qs)
                _no_degradation(sched, "olap_pool_f32_parity")
                for sub in sched.finished:
                    served.setdefault(sub.tenant, set()).update(
                        (sub.engine.version, r.src) for r in sub.reqs)
            else:
                tables = {name: q.run() for name, q in qs.items()}
            sync()
        runs[backend] = {"tables": tables, "ids": dict(probe.vids), "wall_s": time.time() - t0,
                         "served": served,
                         "launches": dict(ops.launch_count),
                         "variants": {k: v for k, v in ops.variant_count.items() if v},
                         "models": _models_of(sess), "tok": sess.tok}
        del sess, qs
    c, r = runs["cuda"], runs["reference"]
    parted = parted_rows(c["ids"], r["ids"], r["models"], r["tok"],
                         SESSION_KW["engine_kw"]["buckets"][-1])
    same = {name: c["tables"][name].columns == r["tables"][name].columns for name in c["tables"]}
    parted_keys = {(p["version"], p["prompt"]) for p in parted}
    unexplained = {name: unexplained_rows(c["tables"][name], r["tables"][name],
                                          {src for v, src in c["served"][name]
                                           if (v, src) in parted_keys})
                   for name in c["tables"]}
    line = {"phase": "olap_pool_f32_parity", "model": cfg.name, "layers": layers,
            "dtype": "float32", "recipe": "w8-absmax", "budget": budget,
            "tables_identical": same, "unexplained_rows": unexplained,
            "parted_rows": parted, "near_tie_bound": NEAR_TIE,
            "wall_s": {k: v["wall_s"] for k, v in runs.items()},
            "launches": {k: v["launches"] for k, v in runs.items()},
            "variants": {k: v["variants"] for k, v in runs.items()}}
    emit_pool_line(line, len(r["ids"]))
    print(f"olap_pool_f32_parity: tables identical {same}, {len(parted)} rows parted"
          + "".join(f", gap {p['gap']:.2e} at token {p['token']}" for p in parted), flush=True)
    check(all(p["near_tie"] for p in parted), line)
    check(not any(unexplained.values()), line)
    check(not any(r["launches"].values()), ("reference session launched kernels", r["launches"]))
    if on_card:
        check(c["launches"]["paged_attention"] > 0 and c["launches"]["quant_matmul"] > 0,
              ("pooled f32 session launches", c["launches"]))
    launches = c["launches"]
    del runs, params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return line, launches


# ---------------------------------------------------------------------------
# training and the always-on service
# ---------------------------------------------------------------------------

# benchmarks/common.py's MODEL_CFG, the model the reference trains for its
# benchmarks (the reference's registry has no such entry), and its recipe:
# 300 steps of batch 16, seq 96, adamw(lr=2e-3, warmup=30, total_steps=300)
TINY_OLAP = dict(name="tiny-olap", family="dense", n_layers=4, d_model=128, n_heads=4,
                 n_kv_heads=2, d_ff=384, vocab_size=260, rope_theta=10000.0, max_seq=512)
TINY_TRAIN = dict(steps=300, batch=16, seq_len=96, log_every=100, ckpt_every=150)
TINY_ADAMW = dict(lr=2e-3, warmup=30, total_steps=300)
TINY_CKPT = os.path.join(OUT_DIR, "tiny_olap_ckpt")
# benchmarks/common.make_engine's settings and benchmarks/service.py's budget
SERVICE_ENGINE_KW = dict(slots=8, max_len=160, buckets=(48, 96, 128))
SERVICE_ENTRIES = 3
SERVICE_ROWS = 64
ACC_FLOOR = 0.9                    # the session's accuracy floor (IOLMSession default)
# train_parity: one AdamW step at gemma2-2b's widths in f32, card against CPU
PARITY_LR = 1e-3
LOSS_RTOL = 1e-5                  # the loss: a sum of f32 terms in another order
GNORM_RTOL = 1e-4                 # the grad norm: through every layer's backward
UPDATE_RMS_RTOL = 1e-3            # RMS of the params' difference over the RMS update
# Adam's first step moves each weight by about lr * sign(g): where g is
# within rounding of 0 the two sides may move it in opposite directions, so
# no weight may differ by more than one such flip, 2 lr (plus rounding)
FLIP = 2.0 * PARITY_LR * (1 + 1e-3)
# train_full_width: Adam's first steps move every weight by about lr in the
# direction of its gradient; on random weights at gemma2-2b's widths 3e-4
# (reached at step 2) sent the loss from 3.4 to 44, so the steps stay small
FULL_LR = 1e-5
# the other families' training phases draw from a generator of their own
TRAIN_FAMILY_SEED = 79
# train_family_parity: (arch, layers, optimizer), one f32 step each at its
# published widths, cut so that the CPU's step stays near 25 s: zamba2-7b
# at one group of its layout (6 Mamba layers and the shared block;
# Adafactor, its optimizer at full width), rwkv6-3b at 2 layers,
# qwen2-moe-a2.7b at 1 of its 24 layers (570 M params a layer, and its two
# microbatches run on the CPU too) on rows of 64 tokens (128 before the
# sharded training runs took the time)
TRAIN_FAMILY_PARITY = (("zamba2-7b", 7, "adafactor", 128), ("rwkv6-3b", 2, "adamw", 128),
                       ("qwen2-moe-a2.7b", 1, "adamw", 64))
# train_full_width_<family>: three bf16 steps at the published widths, batch
# 4 in 2 microbatches (PERF.md reckons each peak).  zamba2-7b trains with
# Adafactor: its bf16 params and grads (23.6 GB) and AdamW's two f32 moments
# (47.1 GB) leave no room on the card.  whisper-base's targets are 448 tokens,
# its decoder context.  qwen2-moe-a2.7b runs its first 4 of 24 layers: at
# full depth its 14.3 B params take 57.3 GB in bf16 params and grads alone.
# rwkv6-3b runs 2 steps (3 before the sharded training runs took the time:
# its steps are 12 s each)
TRAIN_FULL_WIDTH = (
    ("hybrid", "zamba2-7b", dict(opt="adafactor", steps=3)),
    ("rwkv", "rwkv6-3b", dict(steps=2)),
    ("vlm", "paligemma-3b", dict(steps=3)),
    ("encdec", "whisper-base", dict(steps=3, seq_len=448)),
    ("moe", "qwen2-moe-a2.7b", dict(steps=3, layers=4, note=(
        "first 4 of 24 layers at the published widths: 14.3 B params at full depth "
        "take 57.3 GB in bf16 params and grads alone"))),
)


def update_errors(new_a, new_b, old):
    """(max |a - b| over FLIP, RMS(a - b) over RMS(b - old)) of two updated
    param trees against the params before the step."""
    from repro_torch.tree import leaves
    la, lb, lo = leaves(new_a), leaves(new_b), leaves(old)
    worst, diff2, upd2 = 0.0, 0.0, 0.0
    for a, b, o in zip(la, lb, lo):
        a, b, o = a.float(), b.to(a.device).float(), o.to(a.device).float()
        worst = max(worst, (a - b).abs().max().item())
        diff2 += torch.sum((a - b) ** 2).item()
        upd2 += torch.sum((b - o) ** 2).item()
    return worst / FLIP, math.sqrt(diff2 / max(upd2, 1e-30))


def _batch(step, cfg, device, batch, seq_len):
    from repro_torch.training import data as D
    b = D.train_batch(step, batch=batch, seq_len=seq_len,
                      tok=D.ByteTokenizer(max(cfg.vocab_size, 260)))
    return {k: torch.from_numpy(b[k]).to(device) for k in ("tokens", "labels")}


def make_optimizer(name: str, lr: float, total_steps: int):
    """The port's AdamW or Adafactor, constant ``lr`` (no warmup)."""
    from repro_torch.training import optimizer as OPT
    return {"adamw": OPT.adamw, "adafactor": OPT.adafactor}[name](
        lr=lr, warmup=0, total_steps=total_steps)


def train_parity(gen, cfg, device="cuda", batch=2, seq_len=128, opt="adamw",
                 name="train_parity"):
    """One ``make_train_step`` step with ``opt`` (AdamW or Adafactor) of
    ``cfg``, a depth cut of a published config at its widths in f32, on
    the card and on the CPU from the same params (drawn from ``gen``) and
    batch: loss, grad norm and updated params agree (LOSS_RTOL,
    GNORM_RTOL, UPDATE_RMS_RTOL and FLIP).  On the card ``remat=True``
    equals ``remat=False`` and two microbatches equal one, within the
    same tolerances.  The step launches none of the four kernels, and K3
    refuses inputs that require grad.  The CPU steps and the comparisons
    with them run as a ``BACKGROUND`` job on host copies of the card's
    results; the line is emitted when that job ends."""
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.training import train_loop as TL
    from repro_torch.tree import leaves, tree_map

    params = api.init_params(gen, cfg)
    optimizer = make_optimizer(opt, PARITY_LR, 10)
    ops.reset_launch_counts()

    def step(p, dev, **kw):
        on_card = torch.device(dev).type == "cuda"
        b = _batch(0, cfg, dev, batch, seq_len)
        fn = TL.make_train_step(cfg, optimizer, **kw)
        p = tree_map(torch.clone, p)            # the step writes into its params
        state = optimizer.init(p)
        if on_card:
            sync()
        t0 = time.time()
        p2, _, m = fn(p, state, b, 0)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if on_card:
            sync()
        return p2, {"loss": loss, "grad_norm": gnorm, "seconds": time.time() - t0}

    card, card_m = step(params, device, remat=True)
    runs = {"card": card_m}
    # an MoE's loss does not split over rows (expert capacity and the aux
    # loss see the whole batch), so its two microbatches are held against
    # two on the CPU instead of one on the card
    split = cfg.family != "moe"
    against = {"no_remat": "card", "cpu": "card",
               "microbatches_2": "card" if split else "cpu_microbatches_2"}
    errs = {}
    other, runs["no_remat"] = step(params, device, remat=False)
    errs["no_remat"] = update_errors(other, card, params)
    del other
    mb2, runs["microbatches_2"] = step(params, device, microbatches=2)
    if split:
        errs["microbatches_2"] = update_errors(mb2, card, params)
    launched = {k: n for k, n in ops.launch_count.items() if n}
    check(not launched, ("the training step launched a kernel", launched))

    def host_copy(tree):
        return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)

    host, card_h = host_copy(params), host_copy(card)
    mb2_h = None if split else host_copy(mb2)
    line = {"phase": name, "model": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
            "optimizer": opt, "batch": batch, "seq_len": seq_len,
            "lr": PARITY_LR, "params": sum(t.numel() for t in leaves(params)),
            "runs": runs, "against": against, "launches": launched}
    del mb2

    def cpu_reference():
        cpu, runs["cpu"] = step(host, "cpu", remat=True)
        errs["cpu"] = update_errors(cpu, card_h, host)
        del cpu
        if not split:
            cpu, runs["cpu_microbatches_2"] = step(host, "cpu", microbatches=2)
            errs["microbatches_2"] = update_errors(mb2_h, cpu, host)
            del cpu
        line["update_errors"] = {k: {"max_over_flip": a, "rms_rel": r}
                                 for k, (a, r) in errs.items()}
        for run, ref in against.items():
            check(abs(runs[run]["loss"] / runs[ref]["loss"] - 1) <= LOSS_RTOL,
                  (cfg.name, run, "loss", runs[run]["loss"], runs[ref]["loss"]))
            check(abs(runs[run]["grad_norm"] / runs[ref]["grad_norm"] - 1) <= GNORM_RTOL,
                  (cfg.name, run, "grad norm", runs[run]["grad_norm"], runs[ref]["grad_norm"]))
            check(errs[run][0] <= 1.0 and errs[run][1] <= UPDATE_RMS_RTOL,
                  (cfg.name, run, "updated params", errs[run]))
        return line

    if torch.device(device).type == "cuda":
        # no backward kernel: a K3 launch on inputs that require grad is refused
        q = torch.randn((1, 1024, 8, 256), device=device, dtype=torch.bfloat16,
                        requires_grad=True)
        kv = torch.randn((1, 1024, 4, 256), device=device, dtype=torch.bfloat16)
        try:
            ops.flash_attention(q, kv, kv)
            refused = None
        except ops.KernelInputError as e:
            refused = str(e)
        check(refused is not None and "no backward" in refused, ("K3 took a grad input", refused))
        check(ops.launch_count["flash_attention"] == 0, "K3 launched on a grad input")
        line["k3_grad_refused"] = refused
    del params, card
    BACKGROUND.run(cpu_reference)
    return line


def train_flops(cfg, batch: int, seq_len: int) -> float:
    """6 N P model flops of a step of ``batch`` rows of ``seq_len`` tokens:
    every position (a vlm's image positions too) through its active params
    (an MoE's top-k routed experts and its shared ones);
    an encdec's ``enc_ctx`` frames through its encoder and its tokens
    through the rest."""
    n = cfg.active_param_count()
    if cfg.family == "encdec":
        d, hd = cfg.d_model, cfg.resolved_head_dim
        attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
        enc = cfg.n_enc_layers * (attn + 2 * d * cfg.d_ff)
        return 6.0 * batch * (enc * cfg.enc_ctx + (n - enc) * seq_len)
    if cfg.family == "vlm":
        seq_len += cfg.n_img_tokens
    return 6.0 * n * batch * seq_len


def family_extra(gen, cfg, batch: int, device):
    """A batch's inputs beyond tokens and labels: a vlm's ``img_embs``
    [batch, n_img, d], an encdec's ``enc_inputs`` [batch, enc_ctx, d],
    drawn from ``gen`` (``_img_embs`` and ``_enc_frames`` per row)."""
    if cfg.family == "vlm":
        return {"img_embs": torch.stack([_img_embs(gen, cfg, device) for _ in range(batch)])}
    if cfg.family == "encdec":
        return {"enc_inputs": torch.stack([_enc_frames(gen, cfg, device)
                                           for _ in range(batch)])}
    return {}


def train_full_width(cfg, device="cuda", steps=5, batch=4, seq_len=1024, microbatches=2,
                     xent_chunk=256, seed=0, opt="adamw", name="train_full_width", note=None):
    """Training steps of ``cfg`` at its published widths in bf16 with
    ``opt`` (AdamW or Adafactor), remat on, ``xent_chunk`` streaming the
    unembed (dense, MoE and vlm; the other families' loss ignores it, as
    the reference's does): params from a seeded generator on the card,
    then ``steps`` steps of ``make_train_step`` on ``train_batch``es, a
    vlm's with ``img_embs`` and an encdec's with ``enc_inputs`` drawn
    from the same generator (``family_extra``).  Records each step's loss
    and grad norm (finite), its wall time between syncs, positions/s
    (every position of the batch, padding and a vlm's image positions
    included: the loss counts them all, but the images), the positions
    that are not padding, the peak memory and ``train_flops`` / (step s x
    BF16_FLOPS)."""
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.training import data as D
    from repro_torch.training import train_loop as TL
    from repro_torch.tree import leaves

    tok = D.ByteTokenizer(max(cfg.vocab_size, 260))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sync()
    before = card_memory()[0]
    t0 = time.time()
    params = api.init_params(gen, cfg)
    optimizer = make_optimizer(opt, FULL_LR, steps)
    state = optimizer.init(params)
    sync()
    init_s = time.time() - t0
    fn = TL.make_train_step(cfg, optimizer, microbatches=microbatches, xent_chunk=xent_chunk,
                            remat=True)
    reset_peak()
    ops.reset_launch_counts()
    n_params = cfg.param_count()
    positions = batch * (seq_len + (cfg.n_img_tokens if cfg.family == "vlm" else 0))
    flops = train_flops(cfg, batch, seq_len)
    per_step = []
    for i in range(steps):
        b = {**_batch(i, cfg, device, batch, seq_len), **family_extra(gen, cfg, batch, device)}
        real = D.train_batch(i, batch=batch, seq_len=seq_len, tok=tok)["weights"].sum()
        sync()
        t0 = time.time()
        params, state, m = fn(params, state, b, i)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        sync()
        dt = time.time() - t0
        check(math.isfinite(loss) and math.isfinite(gnorm), (name, "step", i, loss, gnorm))
        per_step.append({"step": i, "loss": loss, "grad_norm": gnorm, "seconds": dt,
                         "positions_per_s": positions / dt, "real_tokens": int(real),
                         "flop_share": flops / (dt * BF16_FLOPS)})
        del b
    alloc, peak = card_memory()
    launched = {k: n for k, n in ops.launch_count.items() if n}
    check(not launched, (name, "the training step launched a kernel", launched))
    steady = per_step[1:] or per_step
    line = {"phase": name, "model": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
            "params": n_params, "active_params": cfg.active_param_count(), "optimizer": opt,
            "batch": batch, "seq_len": seq_len, "microbatches": microbatches,
            "xent_chunk": xent_chunk if cfg.family in ("dense", "moe", "vlm") else 0,
            "remat": True, "init_s": init_s, "steps": per_step,
            "steady_seconds": sum(s["seconds"] for s in steady) / len(steady),
            "steady_positions_per_s": sum(s["positions_per_s"] for s in steady) / len(steady),
            "positions_per_step": positions, "flops_per_step": flops,
            "steady_flop_share": sum(s["flop_share"] for s in steady) / len(steady),
            "memory_before": before, "peak_memory": peak, "memory_after": alloc,
            "peak_over_before": peak - before,
            "state_bytes": sum(t.numel() * t.element_size() for t in leaves((params, state)))}
    if note:
        line["note"] = note
    del params, state, fn
    emit(line)
    return line


def _same_bits(a, b) -> bool:
    from repro_torch.tree import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def train_tiny_olap(device="cuda", train_kw=None):
    """``tiny-olap`` trained to the reference's own recipe through
    ``train``, with checkpoints every 150 steps under ``OUT_DIR``.
    Gates: the last logged loss below 0.7 of the first (the reference's
    bar); ``restore`` and ``restore_tree`` of the last step equal to the
    state in memory, bit for bit; ``train`` over a directory holding only
    step 150 resumes from it and writes the last step.  The checkpoint
    directory (``TINY_CKPT``) stays for the examples phase, which the
    caller removes after it.  Returns (line, cfg, trained params)."""
    import shutil
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels import ops
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL
    from repro_torch.tree import leaves

    cfg = ModelConfig(**TINY_OLAP)
    kw = dict(TINY_TRAIN, **(train_kw or {}))
    steps, every = kw["steps"], kw["ckpt_every"]
    d, d2 = TINY_CKPT, os.path.join(OUT_DIR, "tiny_olap_resume")
    for x in (d, d2):
        shutil.rmtree(x, ignore_errors=True)
    adamw = dict(TINY_ADAMW, total_steps=steps)
    ops.reset_launch_counts()
    logs = []
    sync()
    t0 = time.time()
    out = TL.train(cfg, TL.TrainConfig(ckpt_dir=d, **kw), OPT.adamw(**adamw),
                   log=logs.append, device=device)
    sync()
    train_s = time.time() - t0
    losses = out["losses"]
    check(losses[-1][1] < 0.7 * losses[0][1], ("tiny-olap loss did not fall", losses))
    state = (out["params"], out["opt_state"])
    check(CK.latest_step(d) == steps, ("last checkpoint", CK.latest_step(d)))
    t0 = time.time()
    restored, step, _ = CK.restore(d, state, device=device)
    restore_s = time.time() - t0
    check(step == steps and _same_bits(restored, state), "restore differs from memory")
    loose, _, _ = CK.restore_tree(d, device=device)
    check(_same_bits(tuple(loose), state), "restore_tree differs from memory")
    del restored, loose
    os.makedirs(d2)
    shutil.copytree(os.path.join(d, f"step_{every:08d}"), os.path.join(d2, f"step_{every:08d}"))
    logs2 = []
    t0 = time.time()
    out2 = TL.train(cfg, TL.TrainConfig(ckpt_dir=d2, **kw), OPT.adamw(**adamw),
                    log=logs2.append, device=device)
    sync()
    resume_s = time.time() - t0
    check(logs2[0] == f"[train] resumed from step {every}", ("resume", logs2[:1]))
    check(CK.latest_step(d2) == steps, ("resumed run's last checkpoint", CK.latest_step(d2)))
    state2 = (out2["params"], out2["opt_state"])
    drift = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(leaves(state), leaves(state2)))
    launched = {k: n for k, n in ops.launch_count.items() if n}
    check(not launched, ("training launched a kernel", launched))
    ckpt_bytes = _dir_bytes(d)
    line = {"phase": "train_tiny_olap", "cfg": TINY_OLAP, "train": kw, "adamw": adamw,
            "params": cfg.param_count(), "seconds": train_s, "losses": losses,
            "loss_ratio": losses[-1][1] / losses[0][1], "log": logs,
            "restore_s": restore_s, "ckpt_bytes": ckpt_bytes, "resume_s": resume_s,
            "resume_log": logs2, "resumed_losses": out2["losses"],
            "resume_bit_identical": _same_bits(state, state2), "resume_max_abs_diff": drift}
    shutil.rmtree(d2, ignore_errors=True)
    emit(line)
    return line, cfg, out["params"]


EXAMPLE_ROWS = 4                   # --rows of the serving examples on the card
EXAMPLE_TRAIN_STEPS = (40, 60)     # train_lm: a short run, then its resume to more steps


class EngineInitProbe:
    """Every ``Engine`` constructed inside the ``with`` block (a wrapper
    around ``Engine.__init__``, restored on exit)."""

    def __enter__(self):
        from repro_torch.serving.engine import Engine
        self.engines, self._real = [], Engine.__init__
        real, engines = self._real, self.engines

        def init(eng, *a, **kw):
            real(eng, *a, **kw)
            engines.append(eng)

        Engine.__init__ = init
        return self

    def __exit__(self, *exc):
        from repro_torch.serving.engine import Engine
        Engine.__init__ = self._real


def _example(name, fn, argv, backend="cuda"):
    """``fn(argv)`` (an example's ``main``) with the launch counts zeroed
    just before it and read just after, its standard output captured and
    echoed: (result, launches, engines built, output, seconds).  Gate:
    every engine it built on ``backend``."""
    import contextlib
    import io
    from repro_torch.kernels import ops
    buf = io.StringIO()
    ops.reset_launch_counts()
    sync()
    t0 = time.time()
    with EngineInitProbe() as probe, contextlib.redirect_stdout(buf):
        out = fn(argv)
    sync()
    dt = time.time() - t0
    launches = dict(ops.launch_count)
    text = buf.getvalue()
    print(f"--- examples/torch_{name}.py {' '.join(argv)} ({dt:.1f} s, launches "
          f"{ {k: n for k, n in launches.items() if n} })\n{text.rstrip()}", flush=True)
    for eng in probe.engines:
        check(eng.backend == backend and eng.stats.backend == backend,
              (name, "engine off the backend", backend, eng.stats.backend))
    return out, launches, probe.engines, text, dt


def examples_phase(ckpt_dir, device="cuda"):
    """The port's five examples (``examples/torch_*.py``) driven through
    their ``main`` on the card, ``torch_common.CKPT_DIR`` pointed at
    ``train_tiny_olap``'s checkpoint (300 steps, so no example trains
    ``tiny-olap`` again).  Gates: every engine on the cuda backend; the
    quickstart's three recipes' bytes equal the CPU's reckoning (the same
    recipes on the quickstart model built on the CPU) and K2 launched;
    train_lm's loss falls and its second invocation resumes from the
    first's checkpoint, launching no kernel; K1 launched by every serving
    example and K2 by multi_tenant; Q4's invocations equal its distinct
    surviving values.  Off the card (a rehearsal) the launch gates do not
    apply.  Returns (line, launches summed over the examples)."""
    import shutil
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_common
    import torch_multi_tenant
    import torch_olap_queries
    import torch_quickstart
    import torch_serve_compressed
    import torch_train_lm
    from repro_torch.models import api
    from repro_torch.training import checkpoint as CK
    check(CK.latest_step(ckpt_dir) == TINY_TRAIN["steps"], ("tiny-olap checkpoint", ckpt_dir))
    torch_common.CKPT_DIR = ckpt_dir
    dev = ["--device", device]
    on_card = torch.device(device).type == "cuda"
    be = "cuda" if on_card else "reference"
    line = {"phase": "examples", "rows": EXAMPLE_ROWS, "checkpoint_step": TINY_TRAIN["steps"]}
    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    # quickstart: its bytes against the same recipes on the CPU
    res, launches, _, _, dt = _example("quickstart", torch_quickstart.main, dev, be)
    cpu = torch_quickstart.compress_and_score(
        api.init_params(torch.Generator().manual_seed(0), torch_quickstart.CFG),
        torch_quickstart.CFG, "cpu", out=lambda _: None)
    got = [rep.bytes_after for rep, _ in res]
    check(got == [rep.bytes_after for rep, _ in cpu], ("quickstart bytes", got))
    check(launches["quant_matmul"] > 0 or not on_card, ("quickstart: no K2 launch", launches))
    add(launches)
    line["quickstart"] = {"seconds": dt, "launches": launches, "bytes": got,
                          "token_agreement": [r.token_agreement for _, r in res],
                          "recipes": [rep.recipe.name for rep, _ in res]}
    # train_lm: a short run, then its resume to more steps
    ck = os.path.join(OUT_DIR, "torch_train_lm_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    runs = []
    for steps in EXAMPLE_TRAIN_STEPS:
        out, launches, _, text, dt = _example("train_lm", torch_train_lm.main,
                                              ["--steps", str(steps), "--ckpt", ck, *dev], be)
        check(not any(launches.values()), ("train_lm launched a kernel", launches))
        runs.append({"steps": steps, "seconds": dt, "losses": out["losses"],
                     "resumed": f"[train] resumed from step {EXAMPLE_TRAIN_STEPS[0]}" in text})
    check(runs[0]["losses"][-1][1] < runs[0]["losses"][0][1], ("train_lm loss", runs[0]))
    check(not runs[0]["resumed"] and runs[1]["resumed"], ("train_lm resume", runs))
    shutil.rmtree(ck, ignore_errors=True)
    line["train_lm"] = runs
    # multi_tenant: three tenants on one pool, the w8 recipe
    (session, sched, results), launches, engines, _, dt = _example(
        "multi_tenant", torch_multi_tenant.main, ["--rows", str(EXAMPLE_ROWS), *dev], be)
    check((launches["paged_attention"] > 0 and launches["quant_matmul"] > 0) or not on_card,
          ("multi_tenant: K1 and K2", launches))
    check(len(results["tenant-b"]) == EXAMPLE_ROWS, ("multi_tenant rows", results))
    add(launches)
    line["multi_tenant"] = {"seconds": dt, "launches": launches, "engines": len(engines),
                            "rows": sched.stats.rows, "ticks": sched.stats.ticks,
                            "resident": session.pool.resident_versions, "log": session.log}
    # serve_compressed: the full grid, Baseline / Perf / Acc served
    (outcome, served), launches, engines, _, dt = _example(
        "serve_compressed", torch_serve_compressed.main, ["--rows", str(EXAMPLE_ROWS), *dev], be)
    check(launches["paged_attention"] > 0 or not on_card, ("serve_compressed: K1", launches))
    check(all(e._paged for e in served.values()), ("serve_compressed layout", served))
    add(launches)
    line["serve_compressed"] = {
        "seconds": dt, "launches": launches, "engines": len(engines),
        "grid": [c.recipe.name for c in outcome.candidates],
        "perf": outcome.perf.recipe.name if outcome.perf else None,
        "acc": outcome.acc.recipe.name if outcome.acc else None,
        "rows_per_s": {k: e.stats.rows_per_s for k, e in served.items()}}
    # olap_queries: Q1-Q4, the grid searched for each query
    got, launches, engines, text, dt = _example(
        "olap_queries", torch_olap_queries.main, ["--rows", str(EXAMPLE_ROWS), *dev], be)
    c4 = got["commits4"]
    distinct = len({v for v, st in zip(c4["lang"], c4["status"]) if st == "ok"})
    check(got["invocations"] == distinct, ("Q4 invocations", got["invocations"], distinct))
    check(launches["paged_attention"] > 0 or not on_card, ("olap_queries: K1", launches))
    check(f"backend={be}" in text, ("olap_queries: EXPLAIN without", be))
    add(launches)
    line["olap_queries"] = {"seconds": dt, "launches": launches, "engines": len(engines),
                            "q4_invocations": got["invocations"], "q4_distinct": distinct,
                            "log": got["session"].log}
    line["launches"] = total
    emit(line)
    return line, total


def service_specs(n_rows: int = SERVICE_ROWS):
    """Q1-Q4 of ``olap_queries`` as wire specs (``Query.to_spec``): Q4's
    status filter as a ``ColumnPredicate``, the spec form of its lambda."""
    from types import SimpleNamespace
    from repro_torch.olap.plan import ColumnPredicate
    from repro_torch.olap.query import Query
    from repro_torch.olap.table import Table
    from repro_torch.training.data import PROMPTS, workload_rows
    builder = SimpleNamespace(pool=None, backend="auto")
    reviews = Table({"review": [r.text for r in workload_rows("summarize", n_rows)]})
    vals = [r.text for r in workload_rows("correct", n_rows)]
    pairs = workload_rows("join", 16)
    left = Table({"name": [p.text.split(" | ")[0] for p in pairs]})
    right = Table({"name": [p.text.split(" | ")[1] for p in pairs]})
    commits4 = Table({"lang": [vals[i % (n_rows // 2)] for i in range(n_rows)],
                      "status": ["ok" if i % 2 == 0 else "wip" for i in range(n_rows)]})
    return {
        "q1_map": Query(reviews, builder).llm_map("review", prompt=PROMPTS["summarize"],
                                                  out_col="summary").to_spec(),
        "q2_correct": Query(Table({"lang": vals}), builder).llm_correct(
            "lang", prompt=PROMPTS["correct"]).to_spec(),
        "q3_join": Query(left, builder).llm_join(right, ("name", "name"),
                                                 prompt=PROMPTS["join"]).to_spec(),
        "q4_filter": Query(commits4, builder).llm_correct(
            "lang", prompt=PROMPTS["correct"], max_new=8)
        .filter(ColumnPredicate("status", "eq", "ok")).to_spec(),
    }


def _http_queries(client, specs):
    """Each tenant's spec through the service in turn: (rows by tenant,
    seconds by tenant); every stream must end with its done event."""
    rows, seconds = {}, {}
    for tenant, spec in specs.items():
        t0 = time.time()
        events = list(client.iter_query(tenant, spec))
        seconds[tenant] = time.time() - t0
        check(events and events[-1]["event"] == "done", (tenant, "stream", events[-1:]))
        rows[tenant] = [e["row"] for e in events if e["event"] == "row"]
        check(len(rows[tenant]) == events[-1]["rows"], (tenant, "rows streamed"))
    return rows, seconds


def _start_service(sess):
    from repro_torch.service import SemanticQueryService, ServiceClient, TenantSLO, serve
    svc = SemanticQueryService(sess, default_slo=TenantSLO(max_inflight_rows=1024,
                                                           max_queries=8))
    server, _ = serve(svc, host="127.0.0.1", port=0, block=False)
    client = ServiceClient(*server.server_address[:2], timeout=900, max_retries=0)
    check(client.healthz()["ok"] is True, "healthz")
    return svc, server, client


def _stop_service(svc, server):
    server.shutdown()
    server.server_close()
    svc.stop()


def _dir_bytes(d) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)


def _serve_and_restart(make_session, specs, warm, first_gates):
    """One service's life and a warm restart: ``specs`` over HTTP to a
    service over ``make_session()``, ``/stats``, ``POST /checkpoint`` into
    ``warm`` and a stop; ``first_gates(sess, rows)`` runs the phase's own
    gates on that session.  The session is dropped (its pool and the
    session refer to each other: the cycle is collected, or its engines
    stay on the card); a new ``make_session()`` restored with
    ``restore_warm_state`` behind a new service answers the same specs.
    Gates: the same rows, no recalibration, no cascade fit, no search, no
    apply, no calibration.  Deletes ``warm`` and returns a dict of the
    rows, the first session's probe, the stats, the seconds by tenant
    before and after, the save and restore seconds and the bytes on disk."""
    import gc
    import shutil
    from repro_torch.service import restore_warm_state

    shutil.rmtree(warm, ignore_errors=True)
    sess = make_session()
    with SessionProbe() as probe:
        svc, server, client = _start_service(sess)
        t0 = time.time()
        rows, seconds = _http_queries(client, specs)
        http_s = time.time() - t0
        stats = client.stats()
        t0 = time.time()
        client.checkpoint(warm)
        save_s = time.time() - t0
        _stop_service(svc, server)
        first_gates(sess, rows)
    del sess, svc, server, client
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    sess2 = make_session()
    with SessionProbe() as probe2:
        sync()
        t0 = time.time()
        restore_warm_state(sess2, warm)
        sync()
        restore_s = time.time() - t0
        svc2, server2, client2 = _start_service(sess2)
        rows2, seconds2 = _http_queries(client2, specs)
        _stop_service(svc2, server2)
    check(rows2 == rows, "warm restart changed rows")
    check(sess2.recalibrations == 0 and sess2.cascade_fits == 0, "warm restart recalibrated")
    check(not probe2.searches and not probe2.applies and not probe2.calibrations,
          "warm restart built")
    warm_bytes = _dir_bytes(warm)
    shutil.rmtree(warm, ignore_errors=True)
    del sess2, svc2, server2, client2
    gc.collect()
    return {"rows": rows, "probe": probe, "stats": stats, "http_s": http_s,
            "seconds": seconds, "restart_seconds": seconds2, "save_s": save_s,
            "restore_s": restore_s, "warm_bytes": warm_bytes}


def service_trained(params, cfg, device="cuda", n_rows: int = SERVICE_ROWS, recipes=None):
    """The always-on service over the trained ``tiny-olap``: an
    ``IOLMSession`` with no ``recipes=`` (the reference's grid), the
    engine settings of ``benchmarks/common.make_engine`` and
    SERVICE_ENTRIES base entries of pool, behind ``serve`` on an ephemeral
    port of 127.0.0.1.  ``ServiceClient`` sends Q1-Q4 (``to_spec``) as four
    tenants, one after another.  Gates: each tenant's HTTP rows equal
    ``Scheduler.run_queries`` of the same spec on a fresh session that
    shares the model cache (the same order, so the same batches); the
    warm restart of ``_serve_and_restart``.  Records each operator's
    candidates (accuracy, agreement, eval rows/s, bytes, kernel designs),
    how many clear ACC_FLOOR, the pick, the build seconds and each
    tenant's p50/p95 from ``/stats``.  Whether a candidate reaches the
    floor is not gated."""
    from repro_torch.olap.query import IOLMSession, query_from_spec
    from repro_torch.serving.scheduler import Scheduler
    from repro_torch.service.core import table_rows

    engine_kw = dict(SERVICE_ENGINE_KW)
    entry, _ = pool_budget(params, cfg, engine_kw)
    budget = int(SERVICE_ENTRIES * entry)
    specs = service_specs(n_rows)
    kw = dict(device=device, engine_kw=engine_kw, pool_budget=budget, recipes=recipes)

    def against_run_queries(sess, rows):
        check(sess.recalibrations == len(specs), ("recalibrations", sess.recalibrations))
        fresh = IOLMSession(params, cfg, **kw)
        fresh.model_cache = sess.model_cache
        sched = Scheduler(fresh.pool, share=8)
        for tenant, spec in specs.items():
            want = table_rows(sched.run_queries({tenant: query_from_spec(spec, fresh)})[tenant])
            check(rows[tenant] == want, (tenant, "HTTP rows differ from run_queries"))
        check(fresh.recalibrations == 0, "the fresh session rebuilt")

    run = _serve_and_restart(lambda: IOLMSession(params, cfg, **kw), specs,
                             os.path.join(OUT_DIR, "warm_tiny_olap"), against_run_queries)
    probe, stats = run["probe"], run["stats"]
    operators = []
    for tenant, search in zip(specs, probe.searches):
        operators.append({"tenant": tenant, "picked": search["picked"],
                          "search_s": search["seconds"],
                          "cleared_floor": sum(c["accuracy"] >= ACC_FLOOR
                                               for c in search["candidates"]),
                          "baseline_rows_per_s": search["baseline_rows_per_s"],
                          "candidates": search["candidates"]})
    tenants = stats["scheduler"]["tenants"]
    line = {"phase": "service_trained", "rows": {t: len(r) for t, r in run["rows"].items()},
            "budget": budget, "entry_bytes": entry,
            **{k: run[k] for k in ("http_s", "seconds", "restart_seconds", "save_s",
                                   "restore_s", "warm_bytes")},
            "calibrations": probe.calibrations, "applies": probe.applies,
            "operators": operators,
            "latency": {t: {k: tenants[t]["latency"][k] for k in ("p50", "p95")}
                        for t in specs},
            "queue_wait": {t: {k: tenants[t]["queue_wait"][k] for k in ("p50", "p95")}
                           for t in specs},
            "pool": stats["pool"], "service": stats["service"],
            "degradations": stats["scheduler"].get("degradations")}
    check(not line["degradations"], ("degradations", line["degradations"]))
    emit(line)
    for op in operators:
        print(f"  {op['tenant']}: pick {op['picked']}, {op['cleared_floor']} of "
              f"{len(op['candidates'])} at accuracy >= {ACC_FLOOR}; " + ", ".join(
                  f"{c['recipe']} {c['accuracy']:.3f}/{c['token_agreement']:.3f}"
                  for c in op["candidates"]), flush=True)
    return line


def service_full_width(base, cfg, device="cuda", n_rows: int = SERVICE_ROWS):
    """One HTTP query at full width: an ``IOLMSession`` over the bf16
    gemma2-2b base with ``olap_session``'s pinned absmax recipes and a
    pool of POOL_ENTRIES base entries behind ``serve``; Q2 as one tenant.
    Gates: its rows equal ``Query.run`` on the same session; the warm
    restart of ``_serve_and_restart`` (the warm state under ``OUT_DIR``).
    Records the bytes on disk and the save and restore seconds."""
    from repro_torch.olap.query import IOLMSession, query_from_spec
    from repro_torch.service.core import table_rows

    _, recipes = session_recipes(cfg)
    _, budget = pool_budget(base, cfg, SESSION_KW["engine_kw"])
    kw = dict(SESSION_KW, device=device, recipes=recipes, pool_budget=budget)
    spec = {"q2_correct": service_specs(n_rows)["q2_correct"]}

    def against_query_run(sess, rows):
        serial = table_rows(query_from_spec(spec["q2_correct"], sess).run())
        check(rows["q2_correct"] == serial, "HTTP rows differ from Query.run")
        check(len(serial) == n_rows, ("rows", len(serial)))

    run = _serve_and_restart(lambda: IOLMSession(base, cfg, **kw), spec,
                             os.path.join(OUT_DIR, "warm_full_width"), against_query_run)
    searches = run["probe"].searches
    tenant = run["stats"]["scheduler"]["tenants"]["q2_correct"]
    line = {"phase": "service_full_width", "rows": len(run["rows"]["q2_correct"]),
            "picked": searches[0]["picked"] if searches else None,
            "seconds": run["seconds"]["q2_correct"],
            "restart_seconds": run["restart_seconds"]["q2_correct"],
            "save_s": run["save_s"], "restore_s": run["restore_s"],
            "warm_bytes": run["warm_bytes"],
            "latency": {k: tenant["latency"][k] for k in ("p50", "p95")},
            "search_s": searches[0]["seconds"] if searches else None}
    emit(line)
    return line


# ---------------------------------------------------------------------------
# the MoE phases: full-width qwen2-moe-a2.7b
# ---------------------------------------------------------------------------

MOE_SEED = 23                    # the MoE phases' generator: earlier phases' draws stay
MOE_KERNEL_SEED = 29             # K2 over experts' checks: adding a case moves no weight
# qwen2-moe-a2.7b's expert linears (K, N): wi and wg, then wo
MOE_EXPERT_SHAPES = [(2048, 1408), (1408, 2048)]
# C of K2 over experts: a decode step of 8 slots; a 14-token template prefix
# (``decode``'s form for 8 < M <= 16); admissions of whole rows of the 32 and
# 64 buckets (``mma``, partial 128-row tiles included), up to 8 rows of 128.
# kernel_quant_matmul_experts_seen adds every shape the MoE phases called.
MOE_C = (8, 14, 32, 64, 256, 512, 1024)
# K1 at qwen2-moe's decode: 8 slots, 16 KV heads of one query head, head dim 128,
# blocks of 32 at max_len 1024; no window or softcap
MOE_PA = {"Kh": 16, "G": 1, "D": 128, "bs": 32, "nblk": 32}


def _dense_weight(gen, K, N, group=128, smooth=False):
    """A [K, N] weight drawn from ``gen`` and quantized with absmax
    (SmoothQuant's ``in_scale`` when ``smooth``)."""
    from repro_torch.core import quantize as Q
    w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
    amax = (torch.rand((K,), generator=gen, device="cuda") * 4 + 0.5) if smooth else None
    return Q.absmax_quantize(w, group=group, amax_x=amax, smooth_alpha=0.5 if smooth else 0.0)


def _expert_stack(gen, E, K, N, smooth=False, group=128):
    """E expert weights [K, N] drawn from ``gen`` and quantized with absmax
    (SmoothQuant's ``in_scale`` when ``smooth``): (q, scale, group, in_scale)."""
    qs = [_dense_weight(gen, K, N, group, smooth) for _ in range(E)]
    ins = torch.stack([t.in_scale for t in qs]) if smooth else None
    return torch.stack([t.q for t in qs]), torch.stack([t.scale for t in qs]), qs[0].group, ins


def _check_expert_case(gen, stack, C, xdt, label):
    """One launch of K2 over experts on x [E, C, K] of ``xdt`` from ``gen``
    against its plain version: it must run the design
    ``ops.quant_matmul_variant`` names, counted as ``expert_<design>``,
    within K2_TOL (f32 within 1e-5).  Returns (record, max abs error)."""
    from repro_torch.kernels import ops, ref
    q, scale, group, ins = stack
    E, K, N = q.shape
    x = torch.randn((E, C, K), generator=gen, device="cuda").to(xdt)
    variant = ops.quant_matmul_variant(xdt, C, N, group)
    before = dict(ops.variant_count)
    got = ops.quant_matmul_experts(x, q, scale, group=group, in_scale=ins)
    want = ref.quant_matmul(x, q, scale, group=group, in_scale=ins)
    torch.cuda.synchronize()
    check(got.dtype == xdt and got.shape == (E, C, N), ("output", got.dtype, got.shape))
    check(variant_delta(before) == {f"quant_matmul.expert_{variant}": 1},
          ("K2 over experts design", E, C, K, N, xdt, label, variant_delta(before)))
    err_abs, err_rel = errors(got, want)
    tol = 1e-5 if xdt == torch.float32 else K2_TOL
    rec = {"E": E, "C": C, "K": K, "N": N, "x": str(xdt).split(".")[-1], "kind": label,
           "group": group, "variant": f"expert_{variant}", "rel_err": err_rel,
           "tolerance": tol}
    check(err_rel < tol, rec)
    return rec, err_abs


def _time_experts(gen, E, C, K, N):
    """One expert linear at [E, C, K] -> N in bf16: kernel, plain version
    and ``torch.bmm`` on the dequantized bf16 stack, and its bound."""
    from repro_torch.kernels import ops, ref
    q, scale, group, _ = _expert_stack(gen, E, K, N)
    x = torch.randn((E, C, K), generator=gen, device="cuda").to(torch.bfloat16)
    wd = ref.dequantize_codes(q, scale, group)
    ms = time_ms(lambda: ops.quant_matmul_experts(x, q, scale, group=group))
    plain_ms = time_ms(lambda: ref.quant_matmul(x, q, scale, group=group))
    lib_ms = time_ms(lambda: torch.bmm(x, wd))
    nbytes = q.numel() + scale.numel() * 4 + x.numel() * 2 + E * C * N * 2
    bms, by = bound(nbytes, 2 * E * C * K * N)
    return {"E": E, "C": C, "K": K, "N": N,
            "variant": "expert_" + ops.quant_matmul_variant(torch.bfloat16, C, N, group),
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, "bound_share": bms / ms, "bytes": nbytes}


def check_quant_matmul_experts():
    """K2 over experts against its plain version (``ref.quant_matmul`` over
    the expert axis) at qwen2-moe's expert shapes, drawn from a generator
    of its own (MOE_KERNEL_SEED): E 60, 30 and 15 (the base and the two
    expert-pruned instances) at every C of MOE_C, 2048 -> 1408 and 1408 ->
    2048; SmoothQuant's ``in_scale`` per expert; f32 x (the FMA design,
    within 1e-5); ffn75's wo, K 1056 in groups of 96 (the FMA design in
    bf16 and f32).  Then K1 at qwen2-moe's decode shape (16 KV heads, G 1,
    D 128).  Then times one expert linear (wi, E 60) in a decode step of
    8 slots (a prefill's is timed by :func:`check_quant_matmul_experts_seen`
    at a shape the main path gave)."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(MOE_KERNEL_SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(E, K, N, C, bf16, None) for E in (60, 30, 15) for K, N in MOE_EXPERT_SHAPES
             for C in MOE_C]
    cases += [(60, 2048, 1408, 8, bf16, "smooth"), (60, 1408, 2048, 1024, bf16, "smooth"),
              (15, 2048, 1408, 8, f32, None), (15, 1408, 2048, 1024, f32, "smooth"),
              (30, 1056, 2048, 8, bf16, "g96"), (30, 1056, 2048, 1024, bf16, "g96"),
              (30, 1056, 2048, 8, f32, "g96")]
    worst_abs, results, stacks = 0.0, [], {}
    for E, K, N, C, xdt, kind in cases:
        key = (E, K, N, kind)
        if key not in stacks:            # one stack per weight, its C values in turn
            stacks = {key: _expert_stack(gen, E, K, N, smooth=kind == "smooth",
                                         group=96 if kind == "g96" else 128)}
        rec, err_abs = _check_expert_case(gen, stacks[key], C, xdt, kind)
        results.append(rec)
        worst_abs = max(worst_abs, err_abs)
    del stacks

    pa_results = []
    for dtype in (bf16, f32):
        for lengths in ([1, 33, 700, 1024, 5, 64, 257, 999], [1, 31, 32, 33, 1024, 63, 65, 96]):
            q, k, v, tables, ln = _paged_inputs(gen, dtype, lengths, **MOE_PA)
            before = dict(ops.variant_count)
            got = ops.paged_attention(q, k, v, tables, ln)
            S, _, H, D = q.shape
            want = ref.paged_attention(q[:, 0].reshape(S, 16, 1, D), k, v, tables,
                                       ln).reshape(S, 1, H, D)
            torch.cuda.synchronize()
            err_rel = errors(got, want)[1]
            pa_results.append({"dtype": str(dtype).split(".")[-1], "lengths": lengths,
                               "rel_err": err_rel, **MOE_PA})
            check(variant_delta(before) == {"paged_attention.split": 1},
                  ("K1 design at qwen2-moe's shape", variant_delta(before)))
            check(bool(torch.isfinite(got).all()) and err_rel < K1_TOL[dtype], pa_results[-1])

    K, N = MOE_EXPERT_SHAPES[0]
    line = {"phase": "kernel", "name": "quant_matmul_experts", "cases": len(results),
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "timed": "one expert linear (wi, E 60, 2048 -> 1408), decode C=8, bf16",
            **_time_experts(gen, 60, 8, K, N), "paged_attention_moe_cases": pa_results,
            "library_note": "torch.bmm on the dequantized bf16 stack"}
    emit(line)
    return line, results


class ExpertShapeProbe:
    """Counts the calls of K2 over experts on the card by shape (E, C, K,
    N, x dtype, group, with ``in_scale``), for the length of a ``with``
    block, from outside the package."""

    def __init__(self):
        import collections
        self.shapes = collections.Counter()

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops, real = ops, ops.quant_matmul_experts
        self._real = real

        def quant_matmul_experts(x, q, scale, *, group, in_scale=None):
            if x.is_cuda:
                self.shapes[(q.shape[0], x.shape[1], q.shape[1], q.shape[2],
                             str(x.dtype).split(".")[-1], group, in_scale is not None)] += 1
            return real(x, q, scale, group=group, in_scale=in_scale)
        ops.quant_matmul_experts = quant_matmul_experts
        return self

    def __exit__(self, *exc):
        self._ops.quant_matmul_experts = self._real
        return False


def check_quant_matmul_experts_seen(main_shapes, session_shapes):
    """K2 over experts against its plain version at every shape that
    ``moe_main_path``'s int8 run and ``moe_session`` gave it (each
    distinct shape once, fresh inputs from a generator of its own), on
    the design each launch there ran.  Then times one expert linear at the
    main path's most frequent prefill shape of wi (E 60)."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(MOE_KERNEL_SEED + 1)
    shapes = sorted(set(main_shapes) | set(session_shapes))
    results, worst_abs, stacks = [], 0.0, {}
    for E, C, K, N, dt, group, smooth in shapes:
        key = (E, K, N, group, smooth)
        if key not in stacks:            # shapes sort by E, so one stack at a time
            stacks = {key: _expert_stack(gen, E, K, N, smooth=smooth, group=group)}
        rec, err_abs = _check_expert_case(gen, stacks[key], C, getattr(torch, dt),
                                          "seen")
        rec["calls"] = {"main_path": main_shapes.get((E, C, K, N, dt, group, smooth), 0),
                        "session": session_shapes.get((E, C, K, N, dt, group, smooth), 0)}
        results.append(rec)
        worst_abs = max(worst_abs, err_abs)
    del stacks
    K, N = MOE_EXPERT_SHAPES[0]
    prefills = {s: n for s, n in main_shapes.items()
                if s[0] == 60 and s[1] > ops.DECODE_M and s[2:4] == (K, N)}
    check(prefills, ("no prefill of wi on the main path", dict(main_shapes)))
    C = max(prefills, key=lambda s: (prefills[s], s[1]))[1]
    prefill = _time_experts(gen, 60, C, K, N)
    line = {"phase": "kernel_quant_matmul_experts_seen", "cases": results,
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "C_main_path": sorted({s[1] for s in main_shapes}),
            "C_session": sorted({s[1] for s in session_shapes}),
            "prefill_timed": f"one expert linear (wi, E 60, 2048 -> 1408) at C={C}, the main "
                             "path's most frequent prefill shape, bf16", "prefill": prefill}
    emit({**line, "cases": len(results)})   # each case in chip_smoke.json
    print(f"K2 over experts at {len(results)} shapes of the MoE path: max rel err "
          f"{line['max_rel_err']:.3g}; prefill C={C}: {prefill['ms']:.4f} ms (bound "
          f"{prefill['bound_ms']:.4f}, plain {prefill['plain_ms']:.4f}, bmm "
          f"{prefill['library_ms']:.4f})", flush=True)
    return line


def moe_per_step(cfg):
    """K2 launches of one decode step or prefill of qwen2-moe's int8
    instance: (dense, over experts) = (7 a layer (wq, wk, wv, attn wo and
    the shared MLP's wi, wg, wo) and the unembed, 3 a layer)."""
    return 7 * cfg.n_layers + 1, 3 * cfg.n_layers


def moe_variants(cfg, steps: int, prefills: int):
    """The kernel designs a bf16 int8 MoE run of ``steps`` decode steps and
    ``prefills`` prefills launches: K2's skinny designs in the steps (8
    slots), its 128-row tiles in the prefills, K1 in the steps."""
    dense, expert = moe_per_step(cfg)
    want = {"quant_matmul.decode": dense * steps, "quant_matmul.expert_decode": expert * steps,
            "quant_matmul.mma": dense * prefills, "quant_matmul.expert_mma": expert * prefills,
            "paged_attention.split": cfg.n_layers * steps}
    return {k: n for k, n in want.items() if n}


class RouteProbe:
    """Records the experts each MoE block routes every token to (the
    top-k of the router's probabilities, recomputed from the block's own
    inputs), for the length of a ``with`` block, from outside the package.
    Only the entering thread's blocks are recorded: a background CPU
    reference (``Background``) runs its own MoE blocks unobserved."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self._L, self._real = L, L.moe_block
        self.routes = []
        thread = threading.get_ident()

        def moe_block(p, x, cfg, **kw):
            if threading.get_ident() != thread:
                return self._real(p, x, cfg, **kw)
            with torch.no_grad():
                logits = L.matmul(x.reshape(-1, x.shape[-1]), p["router"]).float()
                self.routes.append(torch.topk(torch.softmax(logits, -1), cfg.top_k)[1])
            return self._real(p, x, cfg, **kw)
        L.moe_block = moe_block
        return self

    def __exit__(self, *exc):
        self._L.moe_block = self._real
        return False


def differing_routes(a, b) -> int:
    """Tokens whose expert set differs between two runs' routes."""
    return sum(int((torch.sort(x, -1).values != torch.sort(y, -1).values).any(-1).sum())
               for x, y in zip(a, b))


def moe_main_path(gen):
    """Full-width qwen2-moe-a2.7b (24 layers, 60 experts top 4 and 4 shared
    ones; random bf16 weights from ``gen``) compressed with ``w8-absmax``
    and served by ``Engine(slots=8, max_len=1024)`` on the rows of the
    main path, then the bf16 base the same way.  The counts are zeroed
    just before the int8 run and read just after: per decode step 169 K2
    launches on ``decode``, 72 of K2 over experts on ``expert_decode`` and
    24 of K1; per prefill 169 on ``mma`` and 72 on ``expert_mma``.  The
    base run launches K1 only."""
    from repro_torch.configs import qwen2_moe_a2_7b
    from repro_torch.core.compressed import QTensor, param_bytes
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.kernels import ops
    from repro_torch.models import api

    cfg = qwen2_moe_a2_7b.CONFIG
    t0 = time.time()
    base = api.init_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    t0 = time.time()
    int8, _, report = InstanceOptimizer(base, cfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    moe = int8["blocks"][0]["moe"]
    check(all(isinstance(moe[n], QTensor) and moe[n].q.shape[:2] == (cfg.n_layers, 60)
              for n in ("wi", "wg", "wo")), "expert stacks of the int8 instance")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with ExpertShapeProbe() as probe:
        eng8, reqs8 = serve(int8, cfg, "w8-absmax")
    launches = dict(ops.launch_count)
    variants = {k: n for k, n in ops.variant_count.items() if n}
    st8 = eng8.stats
    dense, expert = moe_per_step(cfg)
    check(launches == {"quant_matmul": (dense + expert) * (st8.decode_steps + st8.prefills),
                       "paged_attention": cfg.n_layers * st8.decode_steps,
                       "block_sparse_matmul": 0, "flash_attention": 0},
          ("MoE int8 run launches", launches, st8.decode_steps, st8.prefills))
    check(variants == moe_variants(cfg, st8.decode_steps, st8.prefills),
          ("MoE int8 run designs", variants))
    peak = torch.cuda.max_memory_allocated()

    ops.reset_launch_counts()
    eng16, reqs16 = serve(base, cfg, "base")
    base_launches = dict(ops.launch_count)
    base_variants = {k: n for k, n in ops.variant_count.items() if n}
    check(base_launches["paged_attention"] == cfg.n_layers * eng16.stats.decode_steps
          and base_launches["quant_matmul"] == 0
          and base_variants == {"paged_attention.split": base_launches["paged_attention"]},
          (base_launches, base_variants))
    agree, rows_same = _agreement(reqs16, reqs8)
    line = {"phase": "moe_main_path", "model": cfg.name, "layers": cfg.n_layers,
            "experts": cfg.n_experts, "top_k": cfg.top_k, "rows": len(REVIEWS), "max_new": 32,
            "init_s": init_s, "quantize_s": quant_s,
            "param_bytes_base": param_bytes(base), "param_bytes_int8": param_bytes(int8),
            "compression": report.compression,
            "int8": {"rows_per_s": st8.rows_per_s, "tokens_per_s": st8.tokens_out / st8.wall_s,
                     "wall_s": st8.wall_s, "decode_steps": st8.decode_steps,
                     "prefills": st8.prefills, "prefix_hits": st8.prefix_hits,
                     "cache_hits": st8.cache_hits, "launches": launches, "variants": variants},
            "base": {"rows_per_s": eng16.stats.rows_per_s,
                     "tokens_per_s": eng16.stats.tokens_out / eng16.stats.wall_s,
                     "wall_s": eng16.stats.wall_s, "decode_steps": eng16.stats.decode_steps,
                     "launches": base_launches},
            "max_memory_allocated_int8_run": peak,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "greedy_token_agreement_base_vs_int8": agree,
            "rows_identical_base_vs_int8": rows_same,
            "expert_shapes": {str(k): n for k, n in sorted(probe.shapes.items())}}
    emit(line)
    for name in ("int8", "base"):
        print(f"qwen2-moe {name}: {line[name]['rows_per_s']:.3f} rows/s, "
              f"{line[name]['tokens_per_s']:.1f} tokens/s", flush=True)
    print(f"qwen2-moe param_bytes: base {line['param_bytes_base']}, int8 "
          f"{line['param_bytes_int8']}; quantize {quant_s:.1f} s; max_memory_allocated "
          f"{line['max_memory_allocated']}; greedy agreement base vs int8 "
          f"{line['greedy_token_agreement_base_vs_int8']:.4f}", flush=True)
    del eng16
    return line, launches, variants, base, int8, eng8, probe.shapes


def _moe_step(params, cfg, state, tables, toks, pos, backend, bs, max_len):
    """One paged decode step under ``backend`` on a copy of ``state``:
    (logits, launches, designs, routes)."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.kernels import ops
    from repro_torch.models import api
    st = {sec: [{n: t.clone() for n, t in e.items()} for e in state[sec]]
          for sec in ("blocks", "tail")}
    before, vbefore = dict(ops.launch_count), dict(ops.variant_count)
    with RouteProbe() as probe, kernel_backend(backend), torch.no_grad():
        lg, _ = api.paged_decode_step(params, cfg, st, tables, toks, pos, block_size=bs,
                                      max_len=max_len)
    torch.cuda.synchronize()
    launched = {k: ops.launch_count[k] - before[k] for k in before}
    check(bool(torch.isfinite(lg).all()) and lg.shape == (toks.shape[0], 1, cfg.vocab_size),
          ("MoE decode-step logits", backend, lg.shape))
    return lg.float(), launched, variant_delta(vbefore), probe.routes


def moe_whole_step(gen, params, eng, trials: int = 4, layers: int = 4):
    """One paged decode step of the int8 MoE instance under the cuda and
    the reference backends on the same state.  bf16 at full width, held to
    STEP_BF16_RATIO against the f32 plain step (the tokens whose expert
    sets differ between the bf16 steps counted and printed); f32 at
    qwen2-moe's widths cut to ``layers`` layers (fresh weights from
    ``gen``, compressed with ``w8-absmax``, random pools), within
    STEP_TOL_F32 with identical routes.  The cuda sides launch K2, K2 over
    experts and K1 once a linear and a layer, the reference sides nothing."""
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.models import api
    cfg, S, bs = eng.cfg, eng.slots, eng._block_size
    nblk = eng.max_len // bs
    pos = torch.tensor([90, 95, 100, 105, 110, 115, 120, 600], device="cuda")
    rms = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    dense, expert = moe_per_step(cfg)

    def expect(c, backend, dtype):
        d, e = moe_per_step(c)
        if backend == "reference":
            return {}, {}
        v = "fma" if dtype == torch.float32 else "decode"
        return ({"quant_matmul": d + e, "paged_attention": c.n_layers},
                {f"quant_matmul.{v}": d, f"quant_matmul.expert_{v}": e,
                 "paged_attention.split": c.n_layers})

    p32 = _f32(params)
    bf16_trials = []
    for _ in range(trials):
        perm = torch.randperm(eng._alloc.num_blocks - 1, generator=gen, device="cuda")
        tables = perm[:S * nblk].reshape(S, nblk).to(torch.int32)
        toks = torch.randint(4, 260, (S, 1), generator=gen, device="cuda")
        out = {}
        for dtype, p in ((torch.bfloat16, params), (torch.float32, p32)):
            state = {sec: [{n: t.to(dtype) for n, t in e.items()}
                           for e in eng._slot_state[sec]] for sec in ("blocks", "tail")}
            for backend in ("cuda", "reference"):
                if dtype == torch.float32 and backend == "cuda":
                    continue                     # f32 is held at 4 layers below
                lg, launched, variants, routes = _moe_step(p, cfg, state, tables, toks, pos,
                                                           backend, bs, eng.max_len)
                want_l, want_v = expect(cfg, backend, dtype)
                check({k: n for k, n in launched.items() if n} == want_l,
                      ("MoE step launches", dtype, backend, launched))
                check(variants == want_v, ("MoE step designs", dtype, backend, variants))
                out[dtype, backend] = (lg, routes)
            del state
        (c16, rc), (r16, rr), (r32, _) = (out[torch.bfloat16, "cuda"],
                                          out[torch.bfloat16, "reference"],
                                          out[torch.float32, "reference"])
        bf16_trials.append({
            "bf16_rms_rel_err": rms(c16, r16), "bf16_cuda_vs_f32": rms(c16, r32),
            "bf16_plain_vs_f32": rms(r16, r32),
            "tokens_with_other_experts": differing_routes(rc, rr),
            "routed_tokens": sum(int(r.shape[0]) for r in rr),
            "greedy_agreement_bf16":
                (c16[:, -1].argmax(-1) == r16[:, -1].argmax(-1)).float().mean().item()})
    del p32
    torch.cuda.empty_cache()

    # f32 at `layers` layers: fresh weights, w8-absmax, random pools
    cfg4 = cfg.replace(n_layers=layers, param_dtype="float32")
    base4 = api.init_params(gen, cfg4)
    p4, _, _ = InstanceOptimizer(base4, cfg4).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    del base4
    nb = S * nblk + 1
    state = api.init_paged_cache(cfg4, S, nb, bs, device="cuda")
    for sec in ("blocks", "tail"):
        for e in state[sec]:
            for t in e.values():
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    f32_trials = []
    for _ in range(trials):
        perm = torch.randperm(nb - 1, generator=gen, device="cuda")
        tables = perm[:S * nblk].reshape(S, nblk).to(torch.int32)
        toks = torch.randint(4, 260, (S, 1), generator=gen, device="cuda")
        res = {}
        for backend in ("cuda", "reference"):
            lg, launched, variants, routes = _moe_step(p4, cfg4, state, tables, toks, pos,
                                                       backend, bs, eng.max_len)
            want_l, want_v = expect(cfg4, backend, torch.float32)
            check({k: n for k, n in launched.items() if n} == want_l,
                  ("MoE f32 step launches", backend, launched))
            check(variants == want_v, ("MoE f32 step designs", backend, variants))
            res[backend] = (lg, routes)
        (c32, rc), (r32, rr) = res["cuda"], res["reference"]
        f32_trials.append({"f32_rms_rel_err": rms(c32, r32),
                           "f32_max_abs_err": errors(c32, r32)[0],
                           "tokens_with_other_experts": differing_routes(rc, rr)})
    del p4, state
    cuda_err = sum(r["bf16_cuda_vs_f32"] for r in bf16_trials)
    plain_err = sum(r["bf16_plain_vs_f32"] for r in bf16_trials)
    line = {"phase": "moe_whole_step", "model": cfg.name, "bf16_layers": cfg.n_layers,
            "f32_layers": layers, "bf16_trials": bf16_trials, "f32_trials": f32_trials,
            "tolerance_f32_rms_rel": STEP_TOL_F32, "bf16_ratio_bound": STEP_BF16_RATIO,
            "bf16_ratio": cuda_err / plain_err,
            "launches_per_step": {"quant_matmul": dense + expert,
                                  "paged_attention": cfg.n_layers}}
    emit(line)
    print(f"moe_whole_step: bf16 ratio {line['bf16_ratio']:.3f}, tokens with other experts "
          f"(bf16, of {bf16_trials[0]['routed_tokens']} a step) "
          f"{[r['tokens_with_other_experts'] for r in bf16_trials]}; f32 ({layers} layers) RMS "
          f"error up to {max(r['f32_rms_rel_err'] for r in f32_trials):.2e}", flush=True)
    check(all(r["f32_rms_rel_err"] < STEP_TOL_F32 and r["tokens_with_other_experts"] == 0
              for r in f32_trials), line)
    check(cuda_err <= STEP_BF16_RATIO * plain_err, line)
    return line


def moe_session_recipes(cfg):
    """``w8-absmax`` and absmax copies of the grid's ``w8-expert50`` (30
    experts) and ``w8-expert25`` (15), named as the dense session's."""
    import dataclasses
    from repro_torch.core import policy as POL
    grid = {r.name: r for r in POL.default_recipe_space(cfg)}
    check(grid["w8-expert50"].experts_keep == 30 and grid["w8-expert25"].experts_keep == 15,
          ("grid expert recipes", grid["w8-expert50"], grid["w8-expert25"]))
    return [grid["w8-absmax"],
            dataclasses.replace(grid["w8-expert50"], name="w8a-expert50",
                                quant_method="absmax"),
            dataclasses.replace(grid["w8-expert25"], name="w8a-expert25",
                                quant_method="absmax")]


def moe_session(base, cfg):
    """An ``IOLMSession`` over the qwen2-moe base (cut in depth by the caller) runs Q2
    (``llm_correct`` over 64 values) and Q1 (``llm_map`` over 64 reviews)
    through ``Query.run``: each operator calibrates on its rows (no
    Hessian: none of the three recipes reads one), builds and evaluates
    ``w8-absmax`` and the two expert-pruned instances, which keep the
    experts this query's calibration rows routed to most, and serves the
    pick through ``Engine``.  The model cache is emptied between the two
    queries, so that Q1's three candidates have the card beside the base."""
    import gc
    from repro_torch.core.compressed import QTensor
    from repro_torch.kernels import ops
    from repro_torch.olap.query import IOLMSession, Query
    from repro_torch.olap.table import Table
    from repro_torch.training.data import PROMPTS, workload_rows

    recipes = moe_session_recipes(cfg)
    routed = []

    def on_outcome(optimizer, out):
        """Each layer's routing counts sum to calibration tokens x top_k;
        the pruned candidates keep the most-routed experts, in order."""
        st = optimizer.stats
        check(all(w.H is None for w in st.weights.values()), "a Hessian was calibrated")
        sums, kept_ok = [], True
        for r in range(cfg.n_layers):
            rs = st.weights[f"blocks.0.{r}.moe.router"]
            sums.append(int(rs.route_count.sum().item()))
            imp = rs.route_count + 1e-3 * rs.route_prob
            for c in out.candidates:
                k = c.cfg.n_experts
                if k == cfg.n_experts:
                    continue
                idx = torch.sort(torch.sort(-imp, stable=True).indices[:k]).values
                want = base["blocks"][0]["moe"]["router"][r][:, idx.to(base["embed"].device)]
                kept_ok &= torch.equal(c.params["blocks"][0]["moe"]["router"][r], want)
                kept_ok &= all(isinstance(c.params["blocks"][0]["moe"][n], QTensor)
                               and c.params["blocks"][0]["moe"][n].q.shape[1] == k
                               for n in ("wi", "wg", "wo"))
        routed.append({"calibration_tokens": st.n_tokens, "route_count_sums": sorted(set(sums)),
                       "experts": [c.cfg.n_experts for c in out.candidates],
                       "kept_by_route_count": kept_ok})
        check(set(sums) == {st.n_tokens * cfg.top_k}, ("routing counts", routed[-1]))
        check([c.cfg.n_experts for c in out.candidates] == [60, 30, 15] and kept_ok,
              ("expert-pruned candidates", routed[-1]))

    sess = IOLMSession(base, cfg, device="cuda", recipes=recipes, **SESSION_KW)
    commits = Table({"lang": [r.text for r in workload_rows("correct", 64)]})
    reviews = Table({"review": [r.text for r in workload_rows("summarize", 64)]})
    queries = [("Q2", Query(commits, sess).llm_correct("lang", prompt=PROMPTS["correct"]),
                ["lang", "lang_fixed"]),
               ("Q1", Query(reviews, sess).llm_map("review", prompt=PROMPTS["summarize"],
                                                   out_col="summary"),
                ["review", "summary"])]
    results, peak = [], 0
    ops.reset_launch_counts()
    with SessionProbe(on_outcome=on_outcome) as probe, ExpertShapeProbe() as shapes:
        for name, q, cols in queries:
            steps = [ln for ln in q.explain().splitlines() if " llm " in ln]
            check(steps and all(" backend=cuda " in ln for ln in steps), (name, steps))
            n_search, n_eng, n_apply = (len(probe.searches), len(probe.engines),
                                        len(probe.applies))
            before = dict(ops.variant_count)
            sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            out = q.run()
            sync()
            wall = time.time() - t0
            peak = max(peak, torch.cuda.max_memory_allocated())
            searches, engines = probe.searches[n_search:], probe.engines[n_eng:]
            delta = variant_delta(before)
            in_search = {}
            for s in searches:
                for k, n in s["variants"].items():
                    in_search[k] = in_search.get(k, 0) + n
            served = {k: n - in_search.get(k, 0) for k, n in delta.items()
                      if n - in_search.get(k, 0)}
            check(list(out.columns) == cols and len(out) == 64,
                  (name, "rows or columns", len(out), list(out.columns)))
            check(len(searches) == 1 and [c["recipe"] for c in searches[0]["candidates"]]
                  == [r.name for r in recipes], (name, "search", searches))
            # every step and prefill of the served engines: K2's skinny designs
            # in the steps and in a prefill of at most 16 tokens (a short
            # template prefix), its 128-row tiles in the other prefills
            steps = sum(e["stats"].decode_steps for e in engines)
            calls = steps + sum(e["stats"].prefills for e in engines)
            dense, expert = moe_per_step(cfg)
            check(served.get("quant_matmul.decode", 0) + served.get("quant_matmul.mma", 0)
                  == dense * calls
                  and served.get("quant_matmul.expert_decode", 0)
                  + served.get("quant_matmul.expert_mma", 0) == expert * calls
                  and served.get("paged_attention.split") == cfg.n_layers * steps
                  and served.get("quant_matmul.expert_decode", 0) >= expert * steps
                  and served.get("quant_matmul.expert_mma", 0) > 0
                  and set(served) <= set(moe_variants(cfg, 1, 1)),
                  (name, "served launches", served, steps, calls))
            rec = {"query": name, "wall_s": wall, "rows_per_s": 64 / wall,
                   "picked": searches[0]["picked"], "search_s": searches[0]["seconds"],
                   "candidates": searches[0]["candidates"],
                   "applies": probe.applies[n_apply:], "served_variants": served,
                   "search_variants": in_search, "peak_memory": torch.cuda.max_memory_allocated(),
                   "engines": [{"version": e["version"], "decode_steps": e["stats"].decode_steps,
                                "prefills": e["stats"].prefills, "rows": e["stats"].rows,
                                "backend": e["stats"].backend} for e in engines]}
            results.append(rec)
            print(f"moe {name}: 64 rows in {wall:.2f} s, picked {rec['picked']} (search "
                  f"{rec['search_s']:.2f} s), peak memory {rec['peak_memory']}; " + ", ".join(
                      f"{c['recipe']} {c['param_bytes']} B acc {c['accuracy']:.2f} tok "
                      f"{c['token_agreement']:.2f}" for c in rec["candidates"]) + "; apply s "
                  + ", ".join(f"{a['recipe']} {a['seconds']:.1f}" for a in rec["applies"]),
                  flush=True)
            del out, q
            sess.model_cache._d.clear()          # the card for the next query's candidates
            gc.collect()
            torch.cuda.empty_cache()
    launches = dict(ops.launch_count)
    line = {"phase": "moe_session", "model": cfg.name, "recipes": [r.name for r in recipes],
            "calibrations": probe.calibrations, "routing": routed, "queries": results,
            "launches": launches, "max_memory_allocated": peak, "log": sess.log,
            "expert_shapes": {str(k): n for k, n in sorted(shapes.shapes.items())}}
    emit(line)
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches, shapes.shapes


# ---------------------------------------------------------------------------
# the hybrid phases: full-width zamba2-7b (Mamba2 + one shared attention block)
# ---------------------------------------------------------------------------

HYBRID_SEED = 31                 # the hybrid phases' generator: earlier phases' draws stay
HYBRID_KERNEL_SEED = 37          # K1 and K3 at head dim 112: adding a case moves no weight
# K1 at zamba2's decode: 8 slots, 32 KV heads of one query head (16 after
# kv50), head dim 112, blocks of 32 at max_len 1024; no window or softcap
HYBRID_PA = {"Kh": 32, "G": 1, "D": 112, "bs": 32, "nblk": 32}


def check_paged_attention_d112():
    """K1 at zamba2's head dim 112 (14 bf16 or 28 f32 16-byte pieces a
    row, a lane group with idle lanes) against its plain version: 8 slots,
    32 and 16 KV heads of one query head, tables of 128 and 1024 positions
    with ragged lengths, plain and aliased tables, bf16 and f32.  Then one
    decode call is timed at 128 and 1024 positions a slot (32 KV heads)."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(HYBRID_KERNEL_SEED)
    ragged = {4: [1, 31, 32, 33, 64, 100, 127, 128],
              32: [1, 33, 257, 700, 999, 1024, 512, 65]}
    worst_abs, results = 0.0, []
    for dtype in (torch.bfloat16, torch.float32):
        for Kh in (32, 16):
            for nblk, lengths in ragged.items():
                for alias in (False, True):
                    shape = {**HYBRID_PA, "Kh": Kh, "nblk": nblk, "alias": alias}
                    q, k, v, tables, ln = _paged_inputs(gen, dtype, lengths, **shape)
                    before = dict(ops.variant_count)
                    got = ops.paged_attention(q, k, v, tables, ln)
                    S, _, H, D = q.shape
                    want = ref.paged_attention(q[:, 0].reshape(S, Kh, 1, D), k, v, tables,
                                               ln).reshape(S, 1, H, D)
                    torch.cuda.synchronize()
                    err_abs, err_rel = errors(got, want)
                    results.append({"dtype": str(dtype).split(".")[-1], "lengths": lengths,
                                    "rel_err": err_rel,
                                    "plan": ops.paged_attention_plan(S, Kh, nblk * 32, 0, 32),
                                    **shape})
                    check(variant_delta(before) == {"paged_attention.split": 1},
                          ("K1 design", variant_delta(before)))
                    check(got.dtype == dtype and bool(torch.isfinite(got).all())
                          and err_rel < K1_TOL[dtype], results[-1])
                    worst_abs = max(worst_abs, err_abs)
    timed = {}
    for L in (128, 1024):
        lengths = [L] * 8
        q, k, v, tables, ln = _paged_inputs(gen, torch.bfloat16, lengths, **HYBRID_PA)
        S, _, H, D = q.shape
        Kh = H
        qr = q[:, 0].reshape(S, Kh, 1, D)
        ms = time_ms(lambda: ops.paged_attention(q, k, v, tables, ln))
        plain_ms = time_ms(lambda: ref.paged_attention(qr, k, v, tables, ln))
        kc = k[tables.long()].reshape(S, -1, Kh, D)[:, :L].permute(0, 2, 1, 3).contiguous()
        vc = v[tables.long()].reshape(S, -1, Kh, D)[:, :L].permute(0, 2, 1, 3).contiguous()
        qs = q.permute(0, 2, 1, 3).contiguous()
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qs, kc, vc))
        nbytes = sum(lengths) * Kh * D * 2 * 2 + 2 * q.numel() * 2 + tables.numel() * 4 + S * 4
        flops = sum(lengths) * Kh * D * 2 * 2
        bound_ms, bound_by = bound(nbytes, flops)
        timed[L] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
                    "bytes": nbytes, "plan": ops.paged_attention_plan(S, Kh, 1024, 0, 32)}
    line = {"phase": "kernel", "name": "paged_attention_d112", "cases": len(results),
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "timed": "one decode call at a zamba2 site, S=8 Kh=32 G=1 D=112 bs=32, "
                     "128 positions a slot, bf16 (1024 positions under L1024)",
            "variant": "split", **timed[128], "L1024": timed[1024],
            "library_note": "SDPA on K/V gathered beforehand"}
    emit(line)
    return line, results


def check_flash_attention_d112():
    """K3 at zamba2's head dim 112 against its plain version: the long
    prefill's shape (S = T = 8192, H = Kh = 32) and a ragged ``t_real``
    there, then the tile edges (S of 127, 129 and 200, T not a multiple of
    the 64-key stage, windows, softcap, q_offset, G of 2), bf16 (``mma``,
    7 k-steps and 14 n8 tiles) and f32 (``fma``, padded to 128 columns
    inside the kernel).  Then the long prefill's call is timed in bf16."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(HYBRID_KERNEL_SEED + 1)
    # (B, S, T, H, Kh, D, window, softcap, q_offset, t_real)
    shapes = [(1, 8192, 8192, 32, 32, 112, 0, 0.0, 0, 0),
              (1, 8192, 8192, 32, 32, 112, 0, 0.0, 0, 8001),
              (1, 127, 127, 8, 8, 112, 0, 0.0, 0, 0),
              (2, 129, 129, 4, 2, 112, 0, 50.0, 0, 0),
              (1, 200, 232, 4, 4, 112, 100, 50.0, 32, 0),
              (1, 129, 300, 4, 2, 112, 70, 0.0, 171, 290)]
    worst_abs, results = 0.0, []
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, T, H, Kh, D, win, cap, off, t_real in shapes:
            q, k, v = _attn_inputs(gen, B, S, T, H, Kh, D, dtype)
            kw = dict(causal=True, window=win, softcap=cap, q_offset=off, t_real=t_real)
            before = dict(ops.variant_count)
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == q.shape, ("output", got.shape))
            check(variant_delta(before) == {f"flash_attention.{ops.flash_variant(dtype)}": 1},
                  ("K3 design", variant_delta(before)))
            err_abs, err_rel = errors(got, want)
            results.append({"B": B, "S": S, "T": T, "H": H, "Kh": Kh, "D": D,
                            "window": win, "softcap": cap, "q_offset": off,
                            "t_real": t_real, "dtype": str(dtype).split(".")[-1],
                            "rel_err": err_rel, "variant": ops.flash_variant(dtype)})
            check(bool(torch.isfinite(got).all()) and err_rel < K34_TOL[dtype], results[-1])
            worst_abs = max(worst_abs, err_abs)
            del q, k, v, got, want
    B, S, H, D = 1, 8192, 32, 112
    q, k, v = _attn_inputs(gen, B, S, S, H, H, D, torch.bfloat16)
    t = {"ms": time_ms(lambda: ops.flash_attention(q, k, v, causal=True), reps=10),
         "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v, causal=True), reps=3)}
    qs, ks, vs = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    t["library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True), reps=10)
    t["flops"] = 4.0 * B * H * D * (S * (S + 1) / 2)
    t["bound_ms"], t["bound_by"] = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                                         t["flops"])
    t["bound_share"] = t["bound_ms"] / t["ms"]
    line = {"phase": "kernel", "name": "flash_attention_d112", "cases": len(results),
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "timed": "one zamba2 site's prefill attention, B=1 S=T=8192 H=Kh=32 D=112, "
                     "causal, bf16", "variant": ops.flash_variant(torch.bfloat16),
            "library_note": "SDPA is_causal", **t}
    emit(line)
    return line, results


class QuantShapeProbe:
    """Counts the calls of K2 on dense linears on the card by shape (M, K,
    N, x dtype, group, with ``in_scale``) and the design each runs, for
    the length of a ``with`` block, from outside the package."""

    def __init__(self):
        import collections
        self.shapes = collections.Counter()

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops, real = ops, ops.quant_matmul
        self._real = real

        def quant_matmul(x, q, scale, *, group, in_scale=None, bits=8):
            if x.is_cuda:
                K, N = q.shape
                M = x.numel() // K
                aligned = q.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0
                self.shapes[(M, K, N, str(x.dtype).split(".")[-1], group, in_scale is not None,
                             ops.quant_matmul_variant(x.dtype, M, N, group, aligned))] += 1
            return real(x, q, scale, group=group, in_scale=in_scale, bits=bits)
        ops.quant_matmul = quant_matmul
        return self

    def __exit__(self, *exc):
        self._ops.quant_matmul = self._real
        return False


def _time_dense(gen, M, K, N, group=128):
    """One linear x [M, K] -> N in bf16, its codes in groups of ``group``
    rows: K2, its plain version and ``torch.matmul`` on the dequantized
    bf16 weight, and its bound."""
    from repro_torch.kernels import ops, ref
    qt = _dense_weight(gen, K, N, group)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    wd = ref.dequantize_codes(qt.q, qt.scale, qt.group)
    ms = time_ms(lambda: ops.quant_matmul(x, qt.q, qt.scale, group=qt.group))
    plain_ms = time_ms(lambda: ref.quant_matmul(x, qt.q, qt.scale, group=qt.group))
    lib_ms = time_ms(lambda: torch.matmul(x, wd))
    nbytes = qt.q.numel() + qt.scale.numel() * 4 + M * K * 2 + M * N * 2
    bms, by = bound(nbytes, 2 * M * K * N)
    return {"M": M, "K": K, "N": N, "group": qt.group,
            "variant": ops.quant_matmul_variant(torch.bfloat16, M, N, qt.group),
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, "bound_share": bms / ms, "bytes": nbytes}


def check_quant_matmul_seen(main_shapes, session_shapes, d_model=3584, d_in_proj=14576):
    """K2 against its plain version at every shape that ``hybrid_main_path``
    (its int8 run) and ``hybrid_session`` gave it: each distinct (M, K, N,
    group, ``in_scale``) once, on fresh absmax codes, scales and x from a
    generator of its own (HYBRID_KERNEL_SEED + 1), on the design each
    launch there ran (``decode`` in decode steps, ``mma`` in prefills),
    within K2_TOL (f32 within 1e-5).  Then times zamba2's in_proj
    (``d_model`` -> ``d_in_proj``) at decode M = 8 and at the main path's
    most frequent prefill M."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(HYBRID_KERNEL_SEED + 1)
    check({s[6] for s in main_shapes} == {"decode", "mma"},
          ("K2 designs of the hybrid main path", sorted(set(main_shapes))))
    results, worst_abs = _hold_seen(gen, main_shapes, session_shapes, "hybrid")
    prefills = {s: n for s, n in main_shapes.items()
                if s[6] == "mma" and s[1:3] == (d_model, d_in_proj)}
    check(prefills, ("no prefill of in_proj on the main path", dict(main_shapes)))
    M = max(prefills, key=lambda s: (prefills[s], s[0]))[0]
    decode = _time_dense(gen, 8, d_model, d_in_proj)
    prefill = _time_dense(gen, M, d_model, d_in_proj)
    line = {"phase": "kernel_quant_matmul_seen", "cases": results,
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "M_main_path": sorted({s[0] for s in main_shapes}),
            "M_session": sorted({s[0] for s in session_shapes}),
            "timed": f"zamba2's in_proj ({d_model} -> {d_in_proj}) at decode M=8 and at M={M}, "
                     "the main path's most frequent prefill, bf16",
            "decode": decode, "prefill": prefill,
            "library_note": "torch.matmul on the dequantized bf16 weight"}
    emit({**line, "cases": len(results)})   # each case in chip_smoke.json
    print(f"K2 at {len(results)} shapes of the hybrid path: max rel err "
          f"{line['max_rel_err']:.3g}; in_proj M=8: {decode['ms']:.4f} ms (bound "
          f"{decode['bound_ms']:.4f}, plain {decode['plain_ms']:.4f}, matmul "
          f"{decode['library_ms']:.4f}); M={M}: {prefill['ms']:.4f} ms (bound "
          f"{prefill['bound_ms']:.4f}, plain {prefill['plain_ms']:.4f}, matmul "
          f"{prefill['library_ms']:.4f})", flush=True)
    return line


def _hold_seen(gen, main_shapes, session_shapes, path):
    """K2 against its plain version once at each distinct shape (M, K, N,
    x dtype, group, ``in_scale``, design) of two ``QuantShapeProbe``
    counters, on fresh absmax codes, scales and x from ``gen``, on the
    design the probed launch ran, within K2_TOL (f32 within 1e-5):
    (the cases, the largest absolute error)."""
    from repro_torch.kernels import ops, ref
    shapes = sorted(set(main_shapes) | set(session_shapes),
                    key=lambda s: (s[1], s[2], s[4], s[5], s[0], s[3]))
    results, worst_abs, weights = [], 0.0, {}
    for shape in shapes:
        M, K, N, dt, group, smooth, variant = shape
        key = (K, N, group, smooth)
        if key not in weights:           # sorted by weight: one weight at a time
            weights = {key: _dense_weight(gen, K, N, group, smooth)}
        qt = weights[key]
        xdt = getattr(torch, dt)
        x = torch.randn((M, K), generator=gen, device="cuda").to(xdt)
        before = dict(ops.variant_count)
        got = ops.quant_matmul(x, qt.q, qt.scale, group=qt.group, in_scale=qt.in_scale)
        want = ref.quant_matmul(x, qt.q, qt.scale, group=qt.group, in_scale=qt.in_scale)
        torch.cuda.synchronize()
        check(got.dtype == xdt and got.shape == (M, N), ("output", got.dtype, got.shape))
        check(variant_delta(before) == {f"quant_matmul.{variant}": 1},
              (f"K2 design at a {path} shape", shape, variant_delta(before)))
        err_abs, err_rel = errors(got, want)
        tol = 1e-5 if xdt == torch.float32 else K2_TOL
        rec = {"M": M, "K": K, "N": N, "x": dt, "group": group, "smooth": smooth,
               "variant": variant, "rel_err": err_rel, "tolerance": tol,
               "calls": {"main_path": main_shapes.get(shape, 0),
                         "session": session_shapes.get(shape, 0)}}
        results.append(rec)
        check(err_rel < tol, rec)
        worst_abs = max(worst_abs, err_abs)
    return results, worst_abs


def hybrid_per_step(cfg):
    """(K2, K1) launches of one decode step of zamba2's int8 instance: each
    Mamba layer's in_proj and out_proj, the shared block's 7 linears at
    each site and the unembed (as many in a prefill); K1 once a site."""
    from repro_torch.models.hybrid import layout
    G, K, tail, sites = layout(cfg)
    return 2 * (G * K + tail) + 7 * sites + 1, sites


class PrefixProbe:
    """Times each template prefix an ``Engine`` prefills (its length in
    tokens and seconds, the device synchronized around it), for the length
    of a ``with`` block, from outside the package."""

    def __enter__(self):
        from repro_torch.serving.engine import Engine
        self._cls, real = Engine, Engine._build_prefix_entry
        self._real, self.prefixes = real, []

        def build(eng, key, prefix_ids):
            sync()
            t0 = time.time()
            out = real(eng, key, prefix_ids)
            sync()
            self.prefixes.append({"tokens": len(prefix_ids), "seconds": time.time() - t0})
            return out
        Engine._build_prefix_entry = build
        return self

    def __exit__(self, *exc):
        self._cls._build_prefix_entry = self._real
        return False


def hybrid_main_path(gen, cfg=None, device="cuda"):
    """Full-width zamba2-7b (81 block applications: 70 Mamba2 layers and 11
    sites of one shared attention block; random bf16 weights from ``gen``)
    compressed with ``w8-absmax`` and served by ``Engine(slots=8,
    max_len=1024)`` on the main path's rows with their shared template,
    then the bf16 base the same way.  The counts are zeroed just before the
    int8 run and read just after: per decode step 218 K2 launches on
    ``decode`` and 11 of K1 (one a site, D = 112), per prefill 218 on
    ``mma``; the base run launches K1 only.  ``cfg`` and ``device`` let it
    run at reduced widths on the CPU, where no kernel launches."""
    from repro_torch.configs import zamba2_7b
    from repro_torch.core.compressed import QTensor, param_bytes
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.tree import leaves

    cfg = cfg or zamba2_7b.CONFIG
    on_card = device == "cuda"
    t0 = time.time()
    base = api.init_params(gen, cfg)
    sync()
    init_s = time.time() - t0
    t0 = time.time()
    int8, _, report = InstanceOptimizer(base, cfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    sync()
    quant_s = time.time() - t0
    G, K, tail, sites = api.family_module(cfg).layout(cfg)
    check(isinstance(int8["mamba_groups"]["in_proj"], QTensor)
          and int8["mamba_groups"]["in_proj"].q.shape[:2] == (G, K),
          "the int8 instance's Mamba groups")
    n_params = sum(t.numel() for t in leaves(base))

    def run(params, version):
        with PrefixProbe() as pp:
            eng, reqs = serve(params, cfg, version, device=device)
        check(eng.stats.truncated == 0 and eng._paged and eng._block_size == 32,
              ("the paged layout, no prompt clipped", eng.stats))
        return eng, reqs, pp.prefixes

    reset_peak()
    ops.reset_launch_counts()
    eng8, reqs8, prefixes8 = run(int8, "w8-absmax")
    launches = dict(ops.launch_count)
    variants = {k: n for k, n in ops.variant_count.items() if n}
    st8 = eng8.stats
    k2, k1 = hybrid_per_step(cfg)
    if on_card:
        check(launches == {"quant_matmul": k2 * (st8.decode_steps + st8.prefills),
                           "paged_attention": k1 * st8.decode_steps,
                           "block_sparse_matmul": 0, "flash_attention": 0},
              ("hybrid int8 run launches", launches, st8.decode_steps, st8.prefills))
        check(variants == {"quant_matmul.decode": k2 * st8.decode_steps,
                           "quant_matmul.mma": k2 * st8.prefills,
                           "paged_attention.split": k1 * st8.decode_steps},
              ("hybrid int8 run designs", variants))
    peak = card_memory()[1]
    ops.reset_launch_counts()
    eng16, reqs16, prefixes16 = run(base, "base")
    base_launches = dict(ops.launch_count)
    if on_card:
        check(base_launches == {"quant_matmul": 0, "block_sparse_matmul": 0,
                                "flash_attention": 0,
                                "paged_attention": k1 * eng16.stats.decode_steps},
              ("hybrid base run launches", base_launches))
    agree, rows_same = _agreement(reqs16, reqs8)
    line = {"phase": "hybrid_main_path", "model": cfg.name, "layers": cfg.n_layers,
            "layout": [G, K, tail, sites], "params": n_params,
            "param_count_config": cfg.param_count(), "rows": len(REVIEWS), "max_new": 32,
            "init_s": init_s, "quantize_s": quant_s,
            "param_bytes_base": param_bytes(base), "param_bytes_int8": param_bytes(int8),
            "compression": report.compression,
            "int8": {**_serve_stats(eng8, prefixes8), "launches": launches,
                     "variants": variants},
            "base": {**_serve_stats(eng16, prefixes16), "launches": base_launches},
            "launches_per_step": {"quant_matmul": k2, "paged_attention": k1},
            "max_memory_allocated_int8_run": peak, "max_memory_allocated": card_memory()[1],
            "greedy_token_agreement_base_vs_int8": agree,
            "rows_identical_base_vs_int8": rows_same}
    emit(line)
    for name in ("int8", "base"):
        print(f"zamba2 {name}: {line[name]['rows_per_s']:.3f} rows/s, "
              f"{line[name]['tokens_per_s']:.1f} tokens/s, {line[name]['decode_steps']} steps, "
              f"template prefix {line[name]['template_prefixes']}", flush=True)
    print(f"zamba2 params {n_params}, param_bytes base {line['param_bytes_base']}, int8 "
          f"{line['param_bytes_int8']}; quantize {quant_s:.1f} s; max_memory_allocated "
          f"{line['max_memory_allocated']}", flush=True)
    del eng16
    return line, launches, variants, base, int8, eng8, reqs8


def _state_copy(state, dtype):
    """A copy of a hybrid serving state with its float tensors in ``dtype``
    (the SSD states ``h`` stay f32, as the model keeps them)."""
    return {sec: None if part is None else
            {n: t.to(torch.float32 if n == "h" else dtype, copy=True) for n, t in part.items()}
            for sec, part in state.items()}


def hybrid_whole_step(gen, params, eng, trials: int = 3, layers: int = 15):
    """One paged decode step of the int8 zamba2 instance under the cuda and
    the reference backends on the same state.  bf16 at full depth, held to
    STEP_BF16_RATIO against the f32 plain step; f32 at zamba2's widths cut
    to ``layers`` block applications (15: 2 sites, 2 groups of 6 Mamba
    layers and 1 tail layer, so the tail runs; fresh weights from ``gen``,
    ``w8-absmax``, random states and pools) within STEP_TOL_F32.  The cuda
    sides launch K2 once a linear and K1 once a site, the reference sides
    nothing."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.kernels import ops
    from repro_torch.models import api
    cfg, S, bs = eng.cfg, eng.slots, eng._block_size
    nblk = eng.max_len // bs
    pos = torch.tensor([90, 95, 100, 105, 110, 115, 120, 600], device="cuda")
    rms = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731

    def step(p, c, state, tables, toks, backend, dtype):
        st = _state_copy(state, dtype)
        before, vbefore = dict(ops.launch_count), dict(ops.variant_count)
        with kernel_backend(backend), torch.no_grad():
            lg, _ = api.paged_decode_step(p, c, st, tables, toks, pos, block_size=bs,
                                          max_len=eng.max_len)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in ops.launch_count.items() if n - before[k]}
        k2, k1 = hybrid_per_step(c)
        v = "fma" if dtype == torch.float32 else "decode"
        want = ({} if backend == "reference" else
                {"quant_matmul": k2, "paged_attention": k1})
        check(launched == want, ("hybrid step launches", dtype, backend, launched))
        check(variant_delta(vbefore) == ({} if backend == "reference" else
                                         {f"quant_matmul.{v}": k2,
                                          "paged_attention.split": k1}),
              ("hybrid step designs", dtype, backend, variant_delta(vbefore)))
        check(bool(torch.isfinite(lg).all()) and lg.shape == (S, 1, c.vocab_size),
              ("hybrid decode-step logits", dtype, backend, lg.shape))
        return lg.float()

    p32 = _f32(params)
    bf16_trials = []
    for _ in range(trials):
        perm = torch.randperm(eng._alloc.num_blocks - 1, generator=gen, device="cuda")
        tables = perm[:S * nblk].reshape(S, nblk).to(torch.int32)
        toks = torch.randint(4, 260, (S, 1), generator=gen, device="cuda")
        c16 = step(params, cfg, eng._slot_state, tables, toks, "cuda", torch.bfloat16)
        r16 = step(params, cfg, eng._slot_state, tables, toks, "reference", torch.bfloat16)
        r32 = step(p32, cfg.replace(param_dtype="float32"), eng._slot_state, tables, toks,
                   "reference", torch.float32)
        bf16_trials.append({
            "bf16_rms_rel_err": rms(c16, r16), "bf16_cuda_vs_f32": rms(c16, r32),
            "bf16_plain_vs_f32": rms(r16, r32),
            "greedy_agreement_bf16":
                (c16[:, -1].argmax(-1) == r16[:, -1].argmax(-1)).float().mean().item()})
    del p32
    torch.cuda.empty_cache()

    cfg_f = cfg.replace(n_layers=layers, param_dtype="float32")
    base_f = api.init_params(gen, cfg_f)
    p_f, _, _ = InstanceOptimizer(base_f, cfg_f).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    del base_f
    nb = S * nblk + 1
    state = api.init_paged_cache(cfg_f, S, nb, bs, device="cuda")
    for part in state.values():
        for t in (part or {}).values():
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    f32_trials = []
    for _ in range(trials):
        perm = torch.randperm(nb - 1, generator=gen, device="cuda")
        tables = perm[:S * nblk].reshape(S, nblk).to(torch.int32)
        toks = torch.randint(4, 260, (S, 1), generator=gen, device="cuda")
        c32 = step(p_f, cfg_f, state, tables, toks, "cuda", torch.float32)
        r32 = step(p_f, cfg_f, state, tables, toks, "reference", torch.float32)
        f32_trials.append({"f32_rms_rel_err": rms(c32, r32),
                           "f32_max_abs_err": errors(c32, r32)[0],
                           "greedy_agreement_f32":
                               (c32[:, -1].argmax(-1) == r32[:, -1].argmax(-1)).float()
                               .mean().item()})
    del p_f, state
    cuda_err = sum(r["bf16_cuda_vs_f32"] for r in bf16_trials)
    plain_err = sum(r["bf16_plain_vs_f32"] for r in bf16_trials)
    k2, k1 = hybrid_per_step(cfg)
    line = {"phase": "hybrid_whole_step", "model": cfg.name, "bf16_layers": cfg.n_layers,
            "f32_layers": layers, "f32_layout": list(api.family_module(cfg_f).layout(cfg_f)),
            "bf16_trials": bf16_trials, "f32_trials": f32_trials,
            "tolerance_f32_rms_rel": STEP_TOL_F32, "bf16_ratio_bound": STEP_BF16_RATIO,
            "bf16_ratio": cuda_err / plain_err,
            "launches_per_step": {"quant_matmul": k2, "paged_attention": k1}}
    emit(line)
    print(f"hybrid_whole_step: bf16 ratio {line['bf16_ratio']:.3f}; f32 ({layers} layers) RMS "
          f"error up to {max(r['f32_rms_rel_err'] for r in f32_trials):.2e}", flush=True)
    check(all(r["f32_rms_rel_err"] < STEP_TOL_F32 for r in f32_trials), line)
    check(cuda_err <= STEP_BF16_RATIO * plain_err, line)
    return line


def _serve_rows(params, cfg, layout, device, version):
    """``serve`` in ``layout``: (token ids by prompt, stats, launches,
    designs, the top bucket)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    eng, reqs = serve(params, cfg, version, device=device, kv_layout=layout)
    check(eng._paged == (layout == "paged"), ("layout", layout))
    return ({r.src: list(r.out_ids) for r in reqs}, eng.stats, dict(ops.launch_count),
            {k: n for k, n in ops.variant_count.items() if n}, eng.buckets[-1])


def hybrid_contiguous(gen, int8, cfg, paged_reqs, device="cuda", dense_cfg=None,
                      f32_layers: int = 15, dense_layers: int = 4):
    """The contiguous KV layout (``kv_layout="contiguous"``: slot state from
    ``init_cache``, decode as the model's masked decode over all slots,
    no K1) against the paged one: the int8 zamba2 instance's rows in bf16
    against ``hybrid_main_path``'s paged run, every row equal or parted at
    a near tie (``tie_at``); then in f32 at zamba2's widths cut to
    ``f32_layers`` block applications and at gemma2-2b's cut to
    ``dense_layers`` layers (fresh base weights from ``gen``), the two
    layouts' tokens identical (or parted at an f32 near tie)."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.models import api
    from repro_torch.training.data import ByteTokenizer
    on_card = device == "cuda"
    k2, k1 = hybrid_per_step(cfg)
    tok = ByteTokenizer(max(cfg.vocab_size, 260))
    want = {r.src: list(r.out_ids) for r in paged_reqs}
    got, st, launches, variants, top = _serve_rows(int8, cfg, "contiguous", device,
                                                   "w8-absmax")
    if on_card:
        check(launches == {"quant_matmul": k2 * (st.decode_steps + st.prefills),
                           "paged_attention": 0, "block_sparse_matmul": 0,
                           "flash_attention": 0},
              ("contiguous int8 run launches", launches))
    p32 = _f32(int8)
    parted = [{"prompt": p, **tie_at(int8, cfg, tok, p, got[p], want[p], top, p32)}
              for p in sorted(want) if got[p] != want[p]]
    del p32
    res = {"bf16": {"rows": len(want), "parted": parted, "rows_per_s": st.rows_per_s,
                    "decode_steps": st.decode_steps, "launches": launches,
                    "variants": variants}}
    check(all(p["near_tie"] for p in parted), ("contiguous rows parted", parted))
    dense_cfg = dense_cfg or gemma2_2b.CONFIG.replace(
        n_layers=dense_layers, attn_pattern="LG" * (dense_layers // 2))
    for name, c in (("hybrid_f32", cfg.replace(n_layers=f32_layers, param_dtype="float32")),
                    ("dense_f32", dense_cfg.replace(param_dtype="float32"))):
        params = api.init_params(gen, c)
        rows = {lay: _serve_rows(params, c, lay, device, "base") for lay in ("paged",
                                                                            "contiguous")}
        (a, sa, la, _, top), (b, sb, lb, _, _) = rows["paged"], rows["contiguous"]
        if on_card:
            check(la["paged_attention"] > 0 and lb["paged_attention"] == 0, (name, la, lb))
        tk = ByteTokenizer(max(c.vocab_size, 260))
        parted = [{"prompt": p, **tie_at(params, c, tk, p, b[p], a[p], top)}
                  for p in sorted(a) if a[p] != b[p]]
        res[name] = {"model": c.name, "layers": c.n_layers, "rows": len(a),
                     "identical": not parted, "parted": parted,
                     "rows_per_s": {"paged": sa.rows_per_s, "contiguous": sb.rows_per_s}}
        check(all(p["near_tie"] for p in parted), (name, parted))
        del params
    line = {"phase": "hybrid_contiguous", "model": cfg.name, **res}
    emit(line)
    print("hybrid_contiguous: " + "; ".join(
        f"{k} {len(v['parted'])} of {v['rows']} rows parted" for k, v in res.items()),
        flush=True)
    return line


def hybrid_long_prefill(gen, base, cfg, S: int = 8192):
    """One S-token document through the hybrid's ``prefill``: at S * S >=
    2**26 each shared site's attention takes ``best_attention``'s flash
    branch, so the cuda side launches K3 once a site (D 112; the reference
    side its plain version).  bf16 held to STEP_BF16_RATIO against the f32
    plain prefill, f32 within STEP_TOL_F32; seconds and peak memory."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.kernels import ops
    from repro_torch.models import api
    sites = api.family_module(cfg).layout(cfg)[3]
    rms = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    toks = torch.randint(4, 260, (1, S), generator=gen, device="cuda")
    logits, secs, peaks = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        params = base if dtype == torch.bfloat16 else _f32(base)
        c = cfg.replace(param_dtype=str(dtype).split(".")[-1])
        for backend in ("cuda", "reference"):
            before, vbefore = dict(ops.launch_count), dict(ops.variant_count)
            reset_peak()
            torch.cuda.synchronize()
            t0 = time.time()
            with kernel_backend(backend), torch.no_grad():
                lg, _ = api.prefill(params, c, {"tokens": toks}, max_len=S, compact_local=False)
            torch.cuda.synchronize()
            key = f"{backend}_{str(dtype).split('.')[-1]}"
            secs[key], peaks[key] = time.time() - t0, torch.cuda.max_memory_allocated()
            launched = {k: n - before[k] for k, n in ops.launch_count.items() if n - before[k]}
            check(launched == ({"flash_attention": sites} if backend == "cuda" else {}),
                  ("hybrid prefill launches", key, launched))
            check(variant_delta(vbefore) == ({} if backend == "reference" else
                                             {f"flash_attention.{ops.flash_variant(dtype)}":
                                              sites}),
                  ("hybrid prefill designs", key, variant_delta(vbefore)))
            check(lg.shape == (1, S, cfg.vocab_size) and bool(torch.isfinite(lg).all()),
                  ("hybrid prefill logits", key))
            logits[dtype, backend] = lg.float()
            del lg
        del params
        torch.cuda.empty_cache()
    c16, r16 = logits[torch.bfloat16, "cuda"], logits[torch.bfloat16, "reference"]
    c32, r32 = logits[torch.float32, "cuda"], logits[torch.float32, "reference"]
    line = {"phase": "hybrid_long_prefill", "model": cfg.name, "S": S, "flash_launches": sites,
            "f32_rms_rel_err": rms(c32, r32), "f32_max_abs_err": errors(c32, r32)[0],
            "bf16_rms_rel_err": rms(c16, r16), "bf16_cuda_vs_f32": rms(c16, r32),
            "bf16_plain_vs_f32": rms(r16, r32),
            "greedy_agreement_bf16": (c16[0].argmax(-1) == r16[0].argmax(-1)).float().mean()
            .item(), "seconds": secs, "max_memory_allocated": peaks,
            "tolerance_f32_rms_rel": STEP_TOL_F32, "bf16_ratio_bound": STEP_BF16_RATIO}
    line["bf16_ratio"] = line["bf16_cuda_vs_f32"] / line["bf16_plain_vs_f32"]
    del logits, c16, r16, c32, r32
    torch.cuda.empty_cache()
    emit(line)
    print(f"hybrid_long_prefill S={S}: {sites} K3 launches, f32 RMS error "
          f"{line['f32_rms_rel_err']:.2e}, bf16 ratio {line['bf16_ratio']:.3f}, cuda bf16 in "
          f"{secs['cuda_bfloat16']:.2f} s, peak {peaks['cuda_bfloat16']}", flush=True)
    check(line["f32_rms_rel_err"] < STEP_TOL_F32, line)
    check(line["bf16_cuda_vs_f32"] <= STEP_BF16_RATIO * line["bf16_plain_vs_f32"], line)
    return line


def _family_session(phase, label, base, cfg, recipes, on_outcome, served_gate,
                    device="cuda", n_rows: int = 64, queries=("Q2", "Q1")):
    """Q2 (``llm_correct``) and Q1 (``llm_map``), or those of ``queries``,
    over ``n_rows`` rows each through ``Query.run`` on an ``IOLMSession`` over ``base`` with
    ``recipes``: each operator calibrates on its rows, builds and
    evaluates every recipe (``on_outcome(optimizer, outcome)`` checks the
    calibration and the candidates) and serves the pick.  On the card
    ``served_gate(query, search, served, decode_steps, model_calls)``
    checks the designs the served engine launched.  Every search's
    candidates, seconds and designs, the calibrations, applies and
    engines are recorded; the model cache is emptied between the queries.
    Returns (the phase's line, the launches of the whole phase)."""
    import gc
    from repro_torch.kernels import ops
    from repro_torch.olap.query import IOLMSession, Query
    from repro_torch.olap.table import Table
    from repro_torch.training.data import PROMPTS, workload_rows

    on_card = device == "cuda"
    sess = IOLMSession(base, cfg, device=device, recipes=recipes, **SESSION_KW)
    commits = Table({"lang": [r.text for r in workload_rows("correct", n_rows)]})
    reviews = Table({"review": [r.text for r in workload_rows("summarize", n_rows)]})
    built = {"Q2": (Query(commits, sess).llm_correct("lang", prompt=PROMPTS["correct"]),
                    ["lang", "lang_fixed"]),
             "Q1": (Query(reviews, sess).llm_map("review", prompt=PROMPTS["summarize"],
                                                 out_col="summary"),
                    ["review", "summary"])}
    queries = [(name, *built[name]) for name in queries]
    results, peak = [], 0
    ops.reset_launch_counts()
    with SessionProbe(on_outcome=on_outcome) as probe:
        for name, q, cols in queries:
            steps = [ln for ln in q.explain().splitlines() if " llm " in ln]
            check(steps and all(f" backend={'cuda' if on_card else 'reference'} " in ln
                                for ln in steps), (name, steps))
            n_search, n_eng, n_apply, n_cal = (len(probe.searches), len(probe.engines),
                                               len(probe.applies), len(probe.calibrations))
            before = dict(ops.variant_count)
            sync()
            reset_peak()
            t0 = time.time()
            out = q.run()
            sync()
            wall = time.time() - t0
            peak = max(peak, card_memory()[1])
            searches, engines = probe.searches[n_search:], probe.engines[n_eng:]
            delta = variant_delta(before)
            in_search = {}
            for s in searches:
                for k, n in s["variants"].items():
                    in_search[k] = in_search.get(k, 0) + n
            served = {k: n - in_search.get(k, 0) for k, n in delta.items()
                      if n - in_search.get(k, 0)}
            check(list(out.columns) == cols and len(out) == n_rows,
                  (name, "rows or columns", len(out), list(out.columns)))
            check(len(searches) == 1 and [c["recipe"] for c in searches[0]["candidates"]]
                  == [r.name for r in recipes], (name, "search", searches))
            n_steps = sum(e["stats"].decode_steps for e in engines)
            calls = n_steps + sum(e["stats"].prefills for e in engines)
            if on_card:
                served_gate(name, searches[0], served, n_steps, calls)
            rec = {"query": name, "wall_s": wall, "rows_per_s": n_rows / wall,
                   "picked": searches[0]["picked"], "search_s": searches[0]["seconds"],
                   "candidates": searches[0]["candidates"],
                   "calibrations": probe.calibrations[n_cal:],
                   "applies": probe.applies[n_apply:], "served_variants": served,
                   "search_variants": in_search, "peak_memory": card_memory()[1],
                   "engines": [{"version": e["version"], "decode_steps": e["stats"].decode_steps,
                                "prefills": e["stats"].prefills, "rows": e["stats"].rows,
                                "truncated": e["stats"].truncated,
                                "backend": e["stats"].backend} for e in engines]}
            results.append(rec)
            print(f"{label} {name}: {n_rows} rows in {wall:.2f} s, picked {rec['picked']} "
                  f"(search {rec['search_s']:.2f} s), peak memory {rec['peak_memory']}; "
                  + ", ".join(f"{c['recipe']} {c['param_bytes']} B acc {c['accuracy']:.2f} tok "
                              f"{c['token_agreement']:.2f}" for c in rec["candidates"])
                  + "; calibrate s " + ", ".join(f"{c['seconds']:.2f}"
                                                 for c in rec["calibrations"])
                  + "; apply s " + ", ".join(f"{a['recipe']} {a['seconds']:.1f}"
                                             for a in rec["applies"]), flush=True)
            del out, q
            sess.model_cache._d.clear()          # the card for the next query's candidates
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
    launches = dict(ops.launch_count)
    line = {"phase": phase, "model": cfg.name, "recipes": [r.name for r in recipes],
            "queries": results, "launches": launches, "max_memory_allocated": peak,
            "log": sess.log}
    del sess
    gc.collect()
    return line, launches


def hybrid_session(base, cfg, device="cuda", n_rows: int = 64):
    """An ``IOLMSession`` over the zamba2 base (cut in groups by the
    caller) runs Q2
    (``llm_correct``) and Q1 (``llm_map``) over ``n_rows`` rows through
    ``Query.run`` (``_family_session``): each operator calibrates on its
    rows (Mamba layers, the shared block's statistics summed over its
    sites; no Hessian: none of the three recipes reads one), builds and
    evaluates ``w8-absmax`` and absmax copies of the grid's ``w8-ffn75``
    (the shared MLP at d_ff 10752, all sites at once) and ``w8-kv50`` (16
    KV groups), and serves the pick through the paged ``Engine`` (K1 at
    each site, K2 on every linear)."""
    from repro_torch.models import api
    _, recipes = session_recipes(cfg)
    k2, k1 = hybrid_per_step(cfg)
    sites = api.family_module(cfg).layout(cfg)[3]
    calibrated = []

    def on_outcome(optimizer, out):
        st = optimizer.stats
        check(all(w.H is None for w in st.weights.values()), "a Hessian was calibrated")
        shared = st.weights["shared.attn.wq"]
        calibrated.append({"tokens": st.n_tokens, "shared_rows": shared.count,
                           "weights": len(st.weights),
                           "configs": [(c.recipe.name, c.cfg.d_ff, c.cfg.n_kv_heads)
                                       for c in out.candidates]})
        check(shared.count == sites * st.n_tokens, ("shared block rows", calibrated[-1]))
        check([(c.cfg.d_ff, c.cfg.n_kv_heads) for c in out.candidates]
              == [(cfg.d_ff, cfg.n_kv_heads),
                  (int(round(0.75 * cfg.d_ff)) // 8 * 8, cfg.n_kv_heads),
                  (cfg.d_ff, cfg.n_kv_heads // 2)], ("pruned candidates", calibrated[-1]))

    def served_gate(name, search, served, n_steps, calls):
        check(served.get("quant_matmul.decode", 0) + served.get("quant_matmul.mma", 0)
              == k2 * calls and served.get("paged_attention.split") == k1 * n_steps
              and served.get("quant_matmul.decode", 0) >= k2 * n_steps
              and set(served) <= {"quant_matmul.decode", "quant_matmul.mma",
                                  "paged_attention.split"},
              (name, "served launches", served, n_steps, calls))

    line, launches = _family_session("hybrid_session", "zamba2", base, cfg, recipes,
                                     on_outcome, served_gate, device, n_rows)
    line["calibrated"] = calibrated
    emit(line)
    return line, launches


def profile_step(gen, params, eng, steps: int = 5, name="decode_profile"):
    """Where one decode step's time goes: host wall time per step
    (ending in a sync) against device kernel time from torch.profiler,
    split by kernel name, and the device's busy time (the union of the
    kernels' intervals), from which the idle share is taken.  The step is
    the engine's own: paged, or the contiguous layout's ``decode_step``.
    The profiler traces the device alone: nothing here reads the host's
    operators, which are most of its own cost on a step of thousands of
    them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compressed import kernel_backend
    from repro_torch.models import api
    cfg, S, bs = eng.cfg, eng.slots, eng._block_size
    tables = None
    if eng._paged:
        nblk = eng.max_len // bs
        tables = torch.arange(S * nblk, device="cuda", dtype=torch.int32).reshape(S, nblk)
    toks = torch.randint(4, 260, (S, 1), generator=gen, device="cuda")
    pos = torch.full((S,), 100, device="cuda")

    def step():
        with kernel_backend("cuda"), torch.no_grad():
            if tables is None:          # the contiguous layout: its state updates in place
                api.decode_step(params, cfg, eng._slot_state, toks, pos, max_len=eng.max_len)
            else:
                api.paged_decode_step(params, cfg, eng._slot_state, tables, toks, pos,
                                      block_size=bs, max_len=eng.max_len)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():          # device-side events only: kernels, memcpy
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key[:60]] = (by_name.get(ev.key[:60], 0.0)
                                    + ev.self_device_time_total / 1e3 / steps)
    device_ms = sum(by_name.values())
    # the time some kernel runs: a kernel launched as a programmatic
    # dependent starts while the one ahead of it still runs, so the sum of
    # kernel times counts that overlap twice
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    busy_ms = busy_us / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    line = {"phase": name, "steps": steps, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "top_kernels_ms_per_step": dict(top)}
    emit(line)
    return line


# ---------------------------------------------------------------------------
# static_analysis: the hot-path audit of a served engine
# ---------------------------------------------------------------------------

# PERF.md section 5's decode-step byte floors (ms at 3.35 TB/s) of the audited
# int8 engines; the analytic step at profile_step's position must be within
# STEP_FLOOR_RTOL of them
STEP_FLOOR_MS = {"gemma2-2b": 0.98, "rwkv6-3b": 1.00}
STEP_FLOOR_RTOL = 0.05
PROFILE_POSITIONS = 101          # profile_step decodes at position 100: 101 positions
BASELINE = os.path.join(ROOT, "tools", "torch_analysis_baseline.json")


def static_analysis(eng, prof_line, name="static_analysis", kernels=("quant_matmul",)):
    """The hot-path audit (``analysis/jit_audit.py``) of a served engine on
    the card, under ``set_sync_debug_mode("warn")``: every target's calls
    and signatures, the diagnostics by code, the decode step's measured
    FLOPs and bytes against 2 N_active slots and params + 2 x state, the
    kernels launched during the audit by design, and the analytic step
    (``launch/roofline.py`` ``decode_step_cost``, at ``profile_step``'s
    position) beside ``prof_line``'s device-busy and wall ms.  Gates: the
    engine's targets restored, each of ``kernels`` launched, no diagnostic
    outside ``tools/torch_analysis_baseline.json``, none of JIT002, and the
    analytic bytes within STEP_FLOOR_RTOL of PERF.md's byte floor."""
    from repro_torch.analysis import diagnostics as D
    from repro_torch.analysis import jit_audit as JA
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline

    ops.reset_launch_counts()
    t0 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            report = JA.audit_engine(eng)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    audit_s = time.time() - t0
    # the engine's own reads between the step methods (a tick's tokens, the
    # host-to-device copies of its inputs): by design, counted by line
    outside = {}
    for w in caught:
        if JA.SYNC_WARNING in str(w.message):
            where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            outside[where] = outside.get(where, 0) + 1
    launches = dict(ops.launch_count)
    variants = {k: n for k, n in ops.variant_count.items() if n}
    shadowed = {"_insert", "_decode", "_seed", "_prefill", "_prefill_from"} & set(eng.__dict__)
    check(not shadowed and all(getattr(fn, "__self__", None) is eng
                               for fn in eng.jit_targets().values()),
          ("the audit left its recorders on the engine", shadowed))
    for k in kernels:
        check(launches[k] > 0, (name, "no launch of", k, launches))
    by_code = {}
    for d in report.diagnostics:
        by_code.setdefault(d.code, []).append(d.to_dict())
    new = D.load_baseline(BASELINE).new_findings(report.diagnostics)
    check(not new, (name, "findings outside the baseline", [d.to_dict() for d in new]))
    check("JIT002" not in by_code, (name, "slot state copied", by_code.get("JIT002")))
    cfg = eng.cfg
    cost = roofline.decode_step_cost(eng.params, cfg, eng.slots, eng.max_len, eng._slot_state,
                                     positions=PROFILE_POSITIONS)
    bound_ms = cost.t_bound * 1e3
    floor = STEP_FLOOR_MS[cfg.name]
    check(abs(cost.t_memory * 1e3 / floor - 1) <= STEP_FLOOR_RTOL,
          (name, "analytic step bytes vs the byte floor", cost.t_memory * 1e3, floor))
    busy, wall = prof_line["device_busy_ms_per_step"], prof_line["wall_ms_per_step"]
    line = {"phase": name, "model": cfg.name, "layers": cfg.n_layers,
            "layout": "paged" if eng._paged else "contiguous", "audit_s": audit_s,
            "cache_stats": report.cache_stats, "diagnostics_by_code": by_code,
            "syncs_outside_steps": outside,
            "budget": report.budget, "launches": launches, "variants": variants,
            "step_cost": cost.to_dict(), "step_bound_ms": bound_ms,
            "step_bound_by": cost.bound, "byte_floor_ms": floor,
            "profile_device_busy_ms": busy, "profile_wall_ms": wall,
            "bound_share_of_device_busy": bound_ms / busy,
            "bound_share_of_wall": bound_ms / wall}
    emit(line)
    for target, st in report.cache_stats.items():
        print(f"{name} {target}: {st['calls']} calls, {st['signatures']} signatures, "
              f"{st['compiles']} library loads", flush=True)
    print(f"{name} diagnostics: {({c: len(v) for c, v in by_code.items()}) or 'none'}; "
          f"syncs outside the step methods: {outside}", flush=True)
    b = report.budget
    print(f"{name} budget: {b['flops']:.4g} FLOPs a step (2 N_active slots "
          f"{b['expected_flops']:.4g}), {b['bytes']:.4g} bytes (params + 2 x state "
          f"{b['expected_bytes']:.4g}), collective bytes {b['coll_bytes']}", flush=True)
    print(f"{name} launches: {launches}, designs {variants}; audit {audit_s:.2f} s", flush=True)
    print(f"{name} step: bound {bound_ms:.4f} ms ({cost.bound}; byte floor {floor} ms), "
          f"device busy {busy:.3f} ms, wall {wall:.3f} ms: {bound_ms / busy:.3f} of busy, "
          f"{bound_ms / wall:.4f} of wall", flush=True)
    return line, launches


# ---------------------------------------------------------------------------
# the rwkv phases: full-width rwkv6-3b on the contiguous layout
# ---------------------------------------------------------------------------

RWKV_SEED = 41                   # the rwkv phases' generator: earlier phases' draws stay
RWKV_KERNEL_SEED = 43            # K2 at rwkv's shapes: adding a case moves no weight


def rwkv_per_call(cfg):
    """K2 launches of one model call (a decode step or a prefill) of rwkv's
    int8 instance: each layer's five time-mix linears (wr, wk, wv, wg, wo)
    and three channel-mix ones (wk, wv, wr), and the unembed; the decay
    LoRA (wa1, wa2) is never compressed and stays a plain matmul."""
    return 8 * cfg.n_layers + 1


def rwkv_main_path(gen, cfg=None, device="cuda"):
    """Full-width rwkv6-3b (32 layers, d_model 2560, 40 heads of 64, d_ff
    8960, vocab 65536; random bf16 weights from ``gen``) compressed with
    ``w8-absmax`` and served by ``Engine(slots=8, max_len=1024)`` on the
    main path's rows with their shared template, then the bf16 base the
    same way.  ``auto`` lands on the contiguous layout (no paged KV for an
    attention-free model): one batched prefill per admission with
    ``lengths``, every row seeded from the template's recurrent state, one
    batched decode step over the slots.  The counts are zeroed just before
    the int8 run and read just after: per decode step 257 K2 launches on
    ``decode``, per prefill 257 on ``mma``, K1, K3 and K4 never; the base
    run launches nothing.  ``cfg`` and ``device`` let it run at reduced
    widths on the CPU, where no kernel launches."""
    from repro_torch.configs import rwkv6_3b
    from repro_torch.core.compressed import QTensor, param_bytes
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serving.scheduler import slot_state_bytes
    from repro_torch.tree import leaves

    cfg = cfg or rwkv6_3b.CONFIG
    on_card = device == "cuda"
    t0 = time.time()
    base = api.init_params(gen, cfg)
    sync()
    init_s = time.time() - t0
    t0 = time.time()
    int8, _, report = InstanceOptimizer(base, cfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    sync()
    quant_s = time.time() - t0
    tm = int8["blocks"][0]["tm"]
    check(isinstance(tm["wr"], QTensor) and tm["wr"].q.shape[0] == cfg.n_layers
          and not isinstance(tm["wa1"], QTensor) and tm["w0"].dtype == torch.float32,
          "the int8 instance's layer stack")
    n_params = sum(t.numel() for t in leaves(base))
    if cfg == rwkv6_3b.CONFIG:
        check(n_params == 3_073_395_200 and (cfg.n_layers, cfg.d_model) == (32, 2560),
              ("full-width rwkv6-3b", n_params))
    k2 = rwkv_per_call(cfg)

    def run(params, version):
        with PrefixProbe() as pp:
            eng, reqs = serve(params, cfg, version, device=device)
        check(eng.stats.truncated == 0 and not eng._paged,
              ("the contiguous layout, no prompt clipped", eng.stats))
        held = sum(t.numel() * t.element_size() for t in eng._slot_state["blocks"][0].values())
        check(held == eng.slots * slot_state_bytes(cfg, eng.max_len), ("slot state bytes", held))
        return eng, reqs, pp.prefixes

    reset_peak()
    ops.reset_launch_counts()
    eng8, reqs8, prefixes8 = run(int8, "w8-absmax")
    launches = dict(ops.launch_count)
    variants = {k: n for k, n in ops.variant_count.items() if n}
    st8 = eng8.stats
    if on_card:
        check(launches == {"quant_matmul": k2 * (st8.decode_steps + st8.prefills),
                           "paged_attention": 0, "block_sparse_matmul": 0,
                           "flash_attention": 0},
              ("rwkv int8 run launches", launches, st8.decode_steps, st8.prefills))
        check(variants == {"quant_matmul.decode": k2 * st8.decode_steps,
                           "quant_matmul.mma": k2 * st8.prefills},
              ("rwkv int8 run designs", variants))
    peak = card_memory()[1]
    ops.reset_launch_counts()
    eng16, reqs16, prefixes16 = run(base, "base")
    base_launches = dict(ops.launch_count)
    check(not any(base_launches.values()), ("rwkv base run launches", base_launches))
    agree, rows_same = _agreement(reqs16, reqs8)
    line = {"phase": "rwkv_main_path", "model": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "params": n_params, "layout": "contiguous",
            "slot_state_bytes": slot_state_bytes(cfg, 1024),
            "rows": len(REVIEWS), "max_new": 32, "init_s": init_s, "quantize_s": quant_s,
            "param_bytes_base": param_bytes(base), "param_bytes_int8": param_bytes(int8),
            "compression": report.compression,
            "int8": {**_serve_stats(eng8, prefixes8), "launches": launches,
                     "variants": variants},
            "base": {**_serve_stats(eng16, prefixes16), "launches": base_launches},
            "launches_per_call": {"quant_matmul": k2},
            "max_memory_allocated_int8_run": peak, "max_memory_allocated": card_memory()[1],
            "greedy_token_agreement_base_vs_int8": agree,
            "rows_identical_base_vs_int8": rows_same}
    emit(line)
    for name in ("int8", "base"):
        print(f"rwkv6 {name}: {line[name]['rows_per_s']:.3f} rows/s, "
              f"{line[name]['tokens_per_s']:.1f} tokens/s, {line[name]['decode_steps']} steps, "
              f"{line[name]['prefills']} prefills, template prefix "
              f"{line[name]['template_prefixes']}", flush=True)
    print(f"rwkv6 params {n_params}, param_bytes base {line['param_bytes_base']}, int8 "
          f"{line['param_bytes_int8']}; quantize {quant_s:.1f} s; slot state "
          f"{line['slot_state_bytes']} B; max_memory_allocated {line['max_memory_allocated']}",
          flush=True)
    del eng16
    return line, launches, base, int8, eng8


def _rwkv_state_copy(state, dtype=None):
    """A copy of an rwkv slot state; ``dtype`` casts the token-shift
    carries (the WKV states ``S`` stay f32, as the model keeps them)."""
    return {"blocks": [{n: t.to(torch.float32 if n == "S" or dtype is None else dtype,
                                copy=True)
                        for n, t in state["blocks"][0].items()}], "tail": []}


def rwkv_whole_step(gen, params, eng, trials: int = 3, layers: int = 4):
    """One contiguous decode step of the int8 rwkv6-3b instance under the
    cuda and the reference backends on copies of the same slot state (the
    served rows' states).  bf16 at all 32 layers, held to STEP_BF16_RATIO
    against the f32 plain step; f32 at rwkv6-3b's widths cut to
    ``layers`` layers (fresh weights from ``gen``, ``w8-absmax``, random
    states) within STEP_TOL_F32.  The cuda sides launch K2 once a linear
    (``decode`` in bf16, ``fma`` in f32), the reference sides nothing."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.kernels import ops
    from repro_torch.models import api
    cfg, S = eng.cfg, eng.slots
    pos = torch.full((S,), 100, device="cuda")
    rms = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731

    def step(p, c, state, toks, backend, dtype):
        st = _rwkv_state_copy(state, dtype)
        before, vbefore = dict(ops.launch_count), dict(ops.variant_count)
        with kernel_backend(backend), torch.no_grad():
            lg, _ = api.decode_step(p, c, st, toks, pos, max_len=eng.max_len)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in ops.launch_count.items() if n - before[k]}
        k2 = rwkv_per_call(c)
        v = "fma" if dtype == torch.float32 else "decode"
        check(launched == ({} if backend == "reference" else {"quant_matmul": k2}),
              ("rwkv step launches", dtype, backend, launched))
        check(variant_delta(vbefore) == ({} if backend == "reference" else
                                         {f"quant_matmul.{v}": k2}),
              ("rwkv step designs", dtype, backend, variant_delta(vbefore)))
        check(bool(torch.isfinite(lg).all()) and lg.shape == (S, 1, c.vocab_size),
              ("rwkv decode-step logits", dtype, backend, lg.shape))
        return lg.float()

    p32 = _f32(params)
    c32cfg = cfg.replace(param_dtype="float32")
    bf16_trials = []
    for _ in range(trials):
        toks = torch.randint(4, 260, (S, 1), generator=gen, device="cuda")
        c16 = step(params, cfg, eng._slot_state, toks, "cuda", torch.bfloat16)
        r16 = step(params, cfg, eng._slot_state, toks, "reference", torch.bfloat16)
        r32 = step(p32, c32cfg, eng._slot_state, toks, "reference", torch.float32)
        bf16_trials.append({
            "bf16_rms_rel_err": rms(c16, r16), "bf16_cuda_vs_f32": rms(c16, r32),
            "bf16_plain_vs_f32": rms(r16, r32),
            "greedy_agreement_bf16":
                (c16[:, -1].argmax(-1) == r16[:, -1].argmax(-1)).float().mean().item()})
    del p32
    torch.cuda.empty_cache()

    cfg_f = cfg.replace(n_layers=layers, param_dtype="float32")
    base_f = api.init_params(gen, cfg_f)
    p_f, _, _ = InstanceOptimizer(base_f, cfg_f).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    del base_f
    state = api.init_cache(cfg_f, S, eng.max_len, compact_local=False, device="cuda")
    for t in state["blocks"][0].values():
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    f32_trials = []
    for _ in range(trials):
        toks = torch.randint(4, 260, (S, 1), generator=gen, device="cuda")
        c32 = step(p_f, cfg_f, state, toks, "cuda", torch.float32)
        r32 = step(p_f, cfg_f, state, toks, "reference", torch.float32)
        f32_trials.append({"f32_rms_rel_err": rms(c32, r32),
                           "f32_max_abs_err": errors(c32, r32)[0],
                           "greedy_agreement_f32":
                               (c32[:, -1].argmax(-1) == r32[:, -1].argmax(-1)).float()
                               .mean().item()})
    del p_f, state
    cuda_err = sum(r["bf16_cuda_vs_f32"] for r in bf16_trials)
    plain_err = sum(r["bf16_plain_vs_f32"] for r in bf16_trials)
    line = {"phase": "rwkv_whole_step", "model": cfg.name, "bf16_layers": cfg.n_layers,
            "f32_layers": layers, "bf16_trials": bf16_trials, "f32_trials": f32_trials,
            "tolerance_f32_rms_rel": STEP_TOL_F32, "bf16_ratio_bound": STEP_BF16_RATIO,
            "bf16_ratio": cuda_err / plain_err,
            "launches_per_step": {"quant_matmul": rwkv_per_call(cfg)}}
    emit(line)
    print(f"rwkv_whole_step: bf16 ratio {line['bf16_ratio']:.3f}; f32 ({layers} layers) RMS "
          f"error up to {max(r['f32_rms_rel_err'] for r in f32_trials):.2e}", flush=True)
    check(all(r["f32_rms_rel_err"] < STEP_TOL_F32 for r in f32_trials), line)
    check(cuda_err <= STEP_BF16_RATIO * plain_err, line)
    return line


def rwkv_session(base, cfg, device="cuda", n_rows: int = 64):
    """An ``IOLMSession`` over the full-width rwkv6-3b base runs Q2
    (``llm_correct``) and Q1 (``llm_map``) over ``n_rows`` rows through
    ``Query.run`` (``_family_session``): each operator calibrates on its
    rows (no Hessian: neither recipe reads one), builds and evaluates
    ``w8-absmax`` and an absmax copy of the grid's ``w8-ffn75``
    (``w8a-ffn75``: d_ff 6720, its ``cm.wv`` in groups of 120, so K2's
    ``fma`` design in bf16; the grid has no ``w8-kv50`` for rwkv), and
    serves the pick through the contiguous ``Engine`` (K2 on every
    linear, no K1)."""
    _, recipes = session_recipes(cfg)
    check([r.name for r in recipes] == ["w8-absmax", "w8a-ffn75"], recipes)
    k2 = rwkv_per_call(cfg)
    pruned = int(round(0.75 * cfg.d_ff)) // 8 * 8
    calibrated = []

    def on_outcome(optimizer, out):
        st = optimizer.stats
        check(all(w.H is None for w in st.weights.values()), "a Hessian was calibrated")
        calibrated.append({"tokens": st.n_tokens, "weights": len(st.weights),
                           "configs": [(c.recipe.name, c.cfg.d_ff, c.cfg.n_layers)
                                       for c in out.candidates]})
        check(st.weights[f"blocks.0.{cfg.n_layers - 1}.cm.wv"].count == st.n_tokens,
              ("channel-mix rows", calibrated[-1]))
        check([(c.cfg.d_ff, c.cfg.n_layers) for c in out.candidates]
              == [(cfg.d_ff, cfg.n_layers), (pruned, cfg.n_layers)],
              ("pruned candidates", calibrated[-1]))

    def served_gate(name, search, served, n_steps, calls):
        # the pruned candidate's evaluation: 32 launches of each call
        # (cm.wv, groups of 120) on fma, the other 225 on decode/mma
        ffn = search["candidates"][1]["variants"]
        fma = ffn.get("quant_matmul.fma", 0)
        check(fma > 0 and fma * (k2 - cfg.n_layers) == cfg.n_layers * (
            ffn.get("quant_matmul.decode", 0) + ffn.get("quant_matmul.mma", 0)),
            (name, "w8a-ffn75 designs", ffn))
        fma_calls = cfg.n_layers * calls if search["picked"] == "w8a-ffn75" else 0
        check(sum(n for k, n in served.items() if k.startswith("quant_matmul."))
              == k2 * calls and served.get("quant_matmul.fma", 0) == fma_calls
              and set(served) <= {"quant_matmul.decode", "quant_matmul.mma",
                                  "quant_matmul.fma"},
              (name, "served launches", served, n_steps, calls))

    line, launches = _family_session("rwkv_session", "rwkv6", base, cfg, recipes, on_outcome,
                                     served_gate, device, n_rows)
    line["calibrated"] = calibrated
    emit(line)
    if device == "cuda":
        check(launches["quant_matmul"] > 0 and not (launches["paged_attention"]
                                                    or launches["flash_attention"]
                                                    or launches["block_sparse_matmul"]),
              ("rwkv session launches", launches))
    return line, launches


def check_quant_matmul_rwkv(main_shapes, session_shapes, d_model=2560, d_ff=8960):
    """K2 against its plain version at every shape that ``rwkv_main_path``
    (its int8 run) and ``rwkv_session`` gave it (``_hold_seen``, from a
    generator of its own, RWKV_KERNEL_SEED): the main path's ``decode`` and
    ``mma``, and the session's pruned channel-mix ``cm.wv`` (``d_ff`` * 3/4
    -> ``d_model`` in groups of 120) on ``fma``.  Then times that pruned
    ``cm.wv`` and the unpruned one (groups of 128) at decode M = 8 and
    prefill M = 512 against ``torch.matmul`` and their bound."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(RWKV_KERNEL_SEED)
    pruned = int(round(0.75 * d_ff)) // 8 * 8
    check({s[6] for s in main_shapes} == {"decode", "mma"},
          ("K2 designs of the rwkv main path", sorted(set(main_shapes))))
    g120 = {s for s in session_shapes if s[1:3] == (pruned, d_model) and s[4] == 120}
    check(g120 and {s[6] for s in g120} == {"fma"},
          ("the pruned cm.wv in groups of 120 on fma", sorted(g120)))
    results, worst_abs = _hold_seen(gen, main_shapes, session_shapes, "rwkv")
    timed = {f"{name}_M{M}": _time_dense(gen, M, K, d_model, group)
             for name, K, group in (("cm_wv_ffn75_g120", pruned, 120), ("cm_wv_g128", d_ff, 128))
             for M in (8, 512)}
    line = {"phase": "kernel_quant_matmul_rwkv", "cases": results,
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "M_main_path": sorted({s[0] for s in main_shapes}),
            "M_session": sorted({s[0] for s in session_shapes}),
            "g120_shapes": sorted(g120), "timed": timed,
            "library_note": "torch.matmul on the dequantized bf16 weight"}
    emit({**line, "cases": len(results)})   # each case in chip_smoke.json
    print(f"K2 at {len(results)} shapes of the rwkv path ({len(g120)} at group 120): max rel "
          f"err {line['max_rel_err']:.3g}; " + "; ".join(
              f"{k}: {t['variant']} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, plain "
              f"{t['plain_ms']:.4f}, matmul {t['library_ms']:.4f})" for k, t in timed.items()),
          flush=True)
    return line


# ---------------------------------------------------------------------------
# the vlm and encdec phases: full-width paligemma-3b served with image
# embeddings and full-width whisper-base served from encoder frames, both
# on the contiguous layout through the engine's ``extra_inputs``
# ---------------------------------------------------------------------------

VLM_SEED = 47                    # the vlm phases' generator: earlier phases' draws stay
ENCDEC_SEED = 53                 # the encdec phases' generator
VLM_ENCDEC_KERNEL_SEED = 59      # K2 at both paths' shapes: adding a case moves no weight
VLM_MAX_LEN = 1024
ENCDEC_MAX_LEN = 512


def vlm_per_call(cfg):
    """K2 launches of one model call of paligemma's int8 instance: each
    layer's seven linears; the tied unembed reads the bf16 embedding and
    stays a plain matmul."""
    return 7 * cfg.n_layers


def encdec_per_call(cfg, prefill: bool):
    """{design: K2 launches} of one bf16 model call of whisper's int8
    instance.  A decode step: each decoder layer's self-attention (4),
    cross-attention query and output (2) and MLP (2) on ``decode``, the
    untied unembed (N 51865, not a multiple of 16) on ``fma``.  A prefill:
    the encoder's 6 linears a layer and the decoder's 10 (the cross K/V
    projected once) on ``mma``, the unembed on ``fma``."""
    if prefill:
        return {"mma": 6 * cfg.n_enc_layers + 10 * cfg.n_dec_layers, "fma": 1}
    return {"decode": 8 * cfg.n_dec_layers, "fma": 1}


def _img_embs(gen, cfg, device):
    """Seeded stand-in for SigLIP's patch embeddings [n_img, d], scaled as
    ``tests/conftest.py`` scales them."""
    x = torch.randn((cfg.n_img_tokens, cfg.d_model), generator=gen, device=device)
    return (x * 0.1).to(cfg.dtype)


def _enc_frames(gen, cfg, device):
    """Seeded stand-in for whisper's conv/mel frontend: ``enc_ctx`` frames."""
    return torch.randn((cfg.enc_ctx, cfg.d_model), generator=gen, device=device).to(cfg.dtype)


def serve_extra(params, cfg, version, extra, max_len, device="cuda", backend="auto",
                max_new: int = 32):
    """The main path's rows through ``Engine(slots=8, max_len=max_len,
    extra_inputs=extra)``: the contiguous layout, no prefix cache (every
    row carries the same image or frames), the duplicate row a result-cache
    hit."""
    from repro_torch.serving.engine import Engine
    eng = Engine(params, cfg, slots=8, max_len=max_len, backend=backend, version=version,
                 device=device, extra_inputs=extra)
    check(not eng._paged and eng.prefix_cache is None,
          ("the contiguous layout, no prefix cache", eng._paged))
    sync()
    reqs = eng.generate([TEMPLATE + r for r in REVIEWS], max_new=max_new, return_requests=True)
    sync()
    st = eng.stats
    check(all(r.done for r in reqs), "unfinished rows")
    check(st.rows == len(REVIEWS) and st.cache_hits >= 1 and st.prefix_hits == 0
          and st.truncated == 0, st)
    for r in reqs:
        check(1 <= len(r.out_ids) <= max_new and all(0 <= t < cfg.vocab_size for t in r.out_ids),
              ("row tokens", r.out_ids))
        check(math.isfinite(r.confidence) and 0.0 <= r.confidence <= 1.0,
              ("row confidence", r.confidence))
    from repro_torch.serving.scheduler import slot_state_bytes
    from repro_torch.tree import leaves
    held = sum(t.numel() * t.element_size() for t in leaves(eng._slot_state))
    check(held == eng.slots * slot_state_bytes(cfg, max_len), ("slot state bytes", held))
    return eng, reqs


def _tree_copy(tree, dtype=None):
    """A copy of a cache tree, its float tensors cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _tree_copy(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_copy(v, dtype) for v in tree]
    if dtype is not None and tree.is_floating_point():
        return tree.to(dtype, copy=True)
    return tree.clone()


def _family_main_path(phase, label, gen, cfg, n_params, want_params, extra, max_len,
                      int8_gate, device):
    """A family's main path on the contiguous layout with ``extra_inputs``:
    ``cfg`` at random bf16 weights from ``gen``, compressed with
    ``w8-absmax`` and served (``serve_extra``), then the base the same way.
    The counts are zeroed just before the int8 run and read just after;
    ``int8_gate(launches, variants, stats)`` checks them on the card; the
    base run launches nothing."""
    from repro_torch.core.compressed import param_bytes
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serving.scheduler import slot_state_bytes
    from repro_torch.tree import leaves

    t0 = time.time()
    base = api.init_params(gen, cfg)
    sync()
    init_s = time.time() - t0
    got = sum(t.numel() for t in leaves(base))
    if want_params:
        check(got == n_params, (f"full-width {cfg.name}", got))
    extra = {k: v(gen, cfg, device) for k, v in extra.items()}
    t0 = time.time()
    int8, _, report = InstanceOptimizer(base, cfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    sync()
    quant_s = time.time() - t0
    reset_peak()
    ops.reset_launch_counts()
    eng8, reqs8 = serve_extra(int8, cfg, "w8-absmax", extra, max_len, device)
    launches = dict(ops.launch_count)
    variants = {k: n for k, n in ops.variant_count.items() if n}
    if device == "cuda":
        int8_gate(launches, variants, eng8.stats)
    peak = card_memory()[1]
    ops.reset_launch_counts()
    eng16, reqs16 = serve_extra(base, cfg, "base", extra, max_len, device)
    base_launches = dict(ops.launch_count)
    check(not any(base_launches.values()), (f"{label} base run launches", base_launches))
    agree, rows_same = _agreement(reqs16, reqs8)
    line = {"phase": phase, "model": cfg.name, "params": got, "layout": "contiguous",
            "extra_inputs": {k: list(v.shape) for k, v in extra.items()},
            "max_len": max_len, "slot_state_bytes": slot_state_bytes(cfg, max_len),
            "rows": len(REVIEWS), "max_new": 32, "init_s": init_s, "quantize_s": quant_s,
            "param_bytes_base": param_bytes(base), "param_bytes_int8": param_bytes(int8),
            "compression": report.compression,
            "int8": {**_serve_stats(eng8, []), "launches": launches, "variants": variants},
            "base": {**_serve_stats(eng16, []), "launches": base_launches},
            "max_memory_allocated_int8_run": peak, "max_memory_allocated": card_memory()[1],
            "greedy_token_agreement_base_vs_int8": agree,
            "rows_identical_base_vs_int8": rows_same}
    for name in ("int8", "base"):
        print(f"{label} {name}: {line[name]['rows_per_s']:.3f} rows/s, "
              f"{line[name]['tokens_per_s']:.1f} tokens/s, {line[name]['decode_steps']} steps, "
              f"{line[name]['prefills']} prefills", flush=True)
    print(f"{label} params {got}, param_bytes base {line['param_bytes_base']}, int8 "
          f"{line['param_bytes_int8']}; quantize {quant_s:.1f} s; slot state "
          f"{line['slot_state_bytes']} B; max_memory_allocated {line['max_memory_allocated']}",
          flush=True)
    del eng16
    return line, launches, base, int8, eng8, extra, reqs16


def vlm_main_path(gen, cfg=None, device="cuda"):
    """Full-width paligemma-3b (18 layers, d_model 2048, 8 query heads on 1
    KV head of 256, d_ff 16384, vocab 257216, tied; 2,508,662,784 params,
    random bf16 weights from ``gen``) compressed with ``w8-absmax`` and
    served by ``Engine(slots=8, max_len=1024, extra_inputs={"img_embs":
    ...})``, a seeded [256, 2048] image ahead of every row, then the bf16
    base the same way: the contiguous layout, no prefix cache; per decode
    step and per prefill 126 K2 launches (``decode`` in the steps, ``mma``
    in the prefills at M = rows x (256 + bucket)), K1, K3 and K4 never
    (256 + 128 positions stay under the flash threshold).  ``cfg`` and
    ``device`` let it run at reduced widths on the CPU."""
    from repro_torch.configs import paligemma_3b
    cfg = cfg or paligemma_3b.CONFIG
    k2 = vlm_per_call(cfg)

    def gate(launches, variants, st):
        check(launches == {"quant_matmul": k2 * (st.decode_steps + st.prefills),
                           "paged_attention": 0, "block_sparse_matmul": 0,
                           "flash_attention": 0},
              ("vlm int8 run launches", launches, st.decode_steps, st.prefills))
        check(variants == {"quant_matmul.decode": k2 * st.decode_steps,
                           "quant_matmul.mma": k2 * st.prefills},
              ("vlm int8 run designs", variants))

    line, launches, base, int8, eng8, extra, _ = _family_main_path(
        "vlm_main_path", "paligemma", gen, cfg, 2_508_662_784, cfg == paligemma_3b.CONFIG,
        {"img_embs": _img_embs}, VLM_MAX_LEN, gate, device)
    line["launches_per_call"] = {"quant_matmul": k2}
    emit(line)
    return line, launches, base, int8, eng8, extra["img_embs"]


def vlm_whole_step(gen, params, eng, trials: int = 3):
    """One contiguous decode step of the int8 paligemma-3b instance at all
    18 layers in bf16 under the cuda and the reference backends, on copies
    of the served rows' KV (each slot at position 400, past its image and
    text), held to STEP_BF16_RATIO against the f32 plain step.  The cuda
    side launches K2 126 times on ``decode``, the reference side nothing."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.kernels import ops
    from repro_torch.models import api
    cfg, S = eng.cfg, eng.slots
    pos = torch.full((S,), 400, device="cuda")
    rms = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    k2 = vlm_per_call(cfg)

    def step(p, c, toks, backend, dtype):
        st = _tree_copy(eng._slot_state, dtype)
        before, vbefore = dict(ops.launch_count), dict(ops.variant_count)
        with kernel_backend(backend), torch.no_grad():
            lg, _ = api.decode_step(p, c, st, toks, pos, max_len=eng.max_len)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in ops.launch_count.items() if n - before[k]}
        cuda = backend == "cuda"
        check(launched == ({"quant_matmul": k2} if cuda else {}),
              ("vlm step launches", dtype, backend, launched))
        check(variant_delta(vbefore) == ({"quant_matmul.decode": k2} if cuda else {}),
              ("vlm step designs", dtype, backend, variant_delta(vbefore)))
        check(bool(torch.isfinite(lg).all()) and lg.shape == (S, 1, c.vocab_size),
              ("vlm decode-step logits", dtype, backend, lg.shape))
        return lg.float()

    p32, c32 = _f32(params), cfg.replace(param_dtype="float32")
    trials_out = []
    for _ in range(trials):
        toks = torch.randint(4, 260, (S, 1), generator=gen, device="cuda")
        c16 = step(params, cfg, toks, "cuda", torch.bfloat16)
        r16 = step(params, cfg, toks, "reference", torch.bfloat16)
        r32 = step(p32, c32, toks, "reference", torch.float32)
        trials_out.append({
            "bf16_rms_rel_err": rms(c16, r16), "bf16_cuda_vs_f32": rms(c16, r32),
            "bf16_plain_vs_f32": rms(r16, r32),
            "greedy_agreement_bf16":
                (c16[:, -1].argmax(-1) == r16[:, -1].argmax(-1)).float().mean().item()})
    del p32
    torch.cuda.empty_cache()
    cuda_err = sum(r["bf16_cuda_vs_f32"] for r in trials_out)
    plain_err = sum(r["bf16_plain_vs_f32"] for r in trials_out)
    line = {"phase": "vlm_whole_step", "model": cfg.name, "bf16_layers": cfg.n_layers,
            "position": 400, "bf16_trials": trials_out, "bf16_ratio_bound": STEP_BF16_RATIO,
            "bf16_ratio": cuda_err / plain_err, "launches_per_step": {"quant_matmul": k2}}
    emit(line)
    print(f"vlm_whole_step: bf16 ratio {line['bf16_ratio']:.3f}", flush=True)
    check(cuda_err <= STEP_BF16_RATIO * plain_err, line)
    return line


def vlm_session(base, cfg, device="cuda", n_rows: int = 64):
    """An ``IOLMSession`` over the full-width paligemma-3b base runs Q2
    (``llm_correct``) and Q1 (``llm_map``) over ``n_rows`` rows through
    ``Query.run`` (``_family_session``), text only: the session passes no
    image, as the reference's does.  Each operator calibrates on its rows
    (no Hessian), builds and evaluates ``w8-absmax`` and ``w8a-ffn75``
    (d_ff 12288; the grid has no ``w8-kv50`` for one KV head), and serves
    the pick through the contiguous ``Engine`` (K2 on 126 linears a call,
    no K1)."""
    _, recipes = session_recipes(cfg)
    check([r.name for r in recipes] == ["w8-absmax", "w8a-ffn75"], recipes)
    k2 = vlm_per_call(cfg)
    pruned = int(round(0.75 * cfg.d_ff)) // 8 * 8
    calibrated = []

    def on_outcome(optimizer, out):
        st = optimizer.stats
        check(all(w.H is None for w in st.weights.values()), "a Hessian was calibrated")
        calibrated.append({"tokens": st.n_tokens, "weights": len(st.weights),
                           "configs": [(c.recipe.name, c.cfg.d_ff) for c in out.candidates]})
        check([c.cfg.d_ff for c in out.candidates] == [cfg.d_ff, pruned],
              ("pruned candidates", calibrated[-1]))

    def served_gate(name, search, served, n_steps, calls):
        check(served.get("quant_matmul.decode", 0) + served.get("quant_matmul.mma", 0)
              == k2 * calls and served.get("quant_matmul.decode", 0) == k2 * n_steps
              and set(served) <= {"quant_matmul.decode", "quant_matmul.mma"},
              (name, "served launches", served, n_steps, calls))

    line, launches = _family_session("vlm_session", "paligemma", base, cfg, recipes,
                                     on_outcome, served_gate, device, n_rows)
    line["calibrated"] = calibrated
    emit(line)
    if device == "cuda":
        check(launches["quant_matmul"] > 0 and not (launches["paged_attention"]
                                                    or launches["flash_attention"]
                                                    or launches["block_sparse_matmul"]),
              ("vlm session launches", launches))
    return line, launches


def _near_tie_rows(ids_a, ids_b, gap_of):
    """Rows whose tokens differ between two runs: (prompt, first differing
    token, the top-two gap there from ``gap_of(prompt, prefix)``)."""
    out = []
    for text in sorted(ids_b):
        a, b = ids_a[text], ids_b[text]
        if a == b:
            continue
        j = next(i for i in range(min(len(a), len(b)) + 1)
                 if i == min(len(a), len(b)) or a[i] != b[i])
        out.append({"prompt": text, "token": j, "gap": gap_of(text, b[:j])})
    return out


def _f32_engine_runs(params, cfg, extra, max_len, max_new, device="cuda"):
    """The main path's rows through an f32 ``Engine`` with ``extra`` under
    the cuda and the reference backends: ({backend: {prompt: ids}},
    {backend: designs launched}).  The cuda side runs K2's ``fma`` design
    only, the reference side nothing."""
    from repro_torch.kernels import ops
    ids, designs = {}, {}
    for backend in ("cuda", "reference"):
        ops.reset_launch_counts()
        _, reqs = serve_extra(params, cfg, "w8-absmax", extra, max_len, device, backend=backend,
                              max_new=max_new)
        ids[backend] = {r.src: list(r.out_ids) for r in reqs}
        designs[backend] = {k: n for k, n in ops.variant_count.items() if n}
    check(set(designs["cuda"]) == {"quant_matmul.fma"} and not designs["reference"],
          ("f32 designs", designs))
    return ids, designs


def vlm_f32_parity(gen, cfg_full, layers: int = 4, max_new: int = 8):
    """paligemma-3b's widths in f32 cut to ``layers`` layers, ``w8-absmax``,
    a seeded image: the main path's rows through the engine under the cuda
    and the reference backends, and ``forward``'s greedy tokens on each
    image-prefixed sequence on the card (the whole sequence recomputed a
    token at a time).  Rows must be identical, or part at a near tie:
    the plain side's top-two logit gap at the first differing token under
    NEAR_TIE."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.models import api
    from repro_torch.training.data import ByteTokenizer
    cfg = cfg_full.replace(n_layers=layers, param_dtype="float32")
    base = api.init_params(gen, cfg)
    params, _, _ = InstanceOptimizer(base, cfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    del base
    img = _img_embs(gen, cfg, "cuda")
    ids, designs = _f32_engine_runs(params, cfg, {"img_embs": img}, VLM_MAX_LEN, max_new)
    tok = ByteTokenizer(max(cfg.vocab_size, 260))

    def logits(text, out, backend):
        seq = tok.encode(text, bos=True) + [tok.SEP] + out
        with kernel_backend(backend), torch.no_grad():
            lg, _ = api.forward(params, cfg, {"tokens": torch.tensor([seq], device="cuda"),
                                              "img_embs": img[None]})
        return lg[0, -1].float()

    def gap(text, out):
        top = logits(text, out, "reference").topk(2).values
        return (top[0] - top[1]).item()

    greedy = {}
    for text in ids["cuda"]:
        out = []
        while len(out) < max_new:
            out.append(int(logits(text, out, "cuda").argmax()))
            if out[-1] == tok.EOS:
                break
        greedy[text] = out
    across = _near_tie_rows(ids["cuda"], ids["reference"], gap)
    to_forward = _near_tie_rows(ids["cuda"], greedy, gap)
    line = {"phase": "vlm_f32_parity", "model": cfg.name, "layers": layers, "dtype": "float32",
            "recipe": "w8-absmax", "prompts": len(ids["cuda"]), "max_new": max_new,
            "rows_differing_across_backends": across, "rows_differing_from_forward": to_forward,
            "near_tie_bound": NEAR_TIE, "designs": designs}
    emit(line)
    print(f"vlm_f32_parity: {len(across)} of {len(ids['cuda'])} rows differ across backends, "
          f"{len(to_forward)} from forward's greedy tokens", flush=True)
    check(all(d["gap"] < NEAR_TIE for d in across + to_forward), line)
    del params
    torch.cuda.empty_cache()
    return line


def encdec_main_path(gen, cfg=None, device="cuda"):
    """Full-width whisper-base (6 + 6 layers, d_model 512, 8 heads of 64,
    d_ff 2048, vocab 51865, ``enc_ctx`` 1500; 164,291,584 params, random
    bf16 weights from ``gen``) compressed with ``w8-absmax`` and served by
    ``Engine(slots=8, max_len=512, extra_inputs={"enc_inputs": ...})``,
    1500 seeded frames for every row, then the bf16 base the same way: the
    contiguous layout, no prefix cache (``encdec_per_call``: per decode
    step 48 K2 launches on ``decode`` and the unembed's on ``fma``; per
    prefill the encoder's and decoder's 96 on ``mma`` and the unembed's on
    ``fma``), K1, K3 and K4 never.  ``cfg`` and ``device`` let it run at
    reduced widths on the CPU."""
    from repro_torch.configs import whisper_base
    cfg = cfg or whisper_base.CONFIG
    dec, pre = encdec_per_call(cfg, False), encdec_per_call(cfg, True)

    def gate(launches, variants, st):
        steps, prefills = st.decode_steps, st.prefills
        check(launches == {"quant_matmul": sum(dec.values()) * steps
                           + sum(pre.values()) * prefills,
                           "paged_attention": 0, "block_sparse_matmul": 0,
                           "flash_attention": 0},
              ("encdec int8 run launches", launches, steps, prefills))
        check(variants == {"quant_matmul.decode": dec["decode"] * steps,
                           "quant_matmul.mma": pre["mma"] * prefills,
                           "quant_matmul.fma": steps + prefills},
              ("encdec int8 run designs", variants))

    line, launches, base, int8, eng8, extra, reqs16 = _family_main_path(
        "encdec_main_path", "whisper", gen, cfg, 164_291_584, cfg == whisper_base.CONFIG,
        {"enc_inputs": _enc_frames}, ENCDEC_MAX_LEN, gate, device)
    line["launches_per_call"] = {"decode_step": dec, "prefill": pre}
    emit(line)
    return line, launches, base, int8, eng8, extra["enc_inputs"], reqs16


def encdec_build(base, cfg, frames, base_reqs, device="cuda"):
    """A per-query build of whisper-base: ``InstanceOptimizer`` calibrates
    on 16 of the main path's rows (96 tokens each) with their
    ``enc_inputs`` (the 1500 frames every row carries; no Hessian), then
    applies ``w8-absmax`` and absmax copies of the grid's ``w8-ffn75``
    (d_ff 1536) and ``w8-kv50`` (4 of 8 heads in every self- and
    cross-attention), each served on the main path's rows; agreement with
    the base rows, build seconds and K2's launches by design recorded.
    This is the session's build without its search: the session passes no
    ``enc_inputs`` (``Query.run`` over encdec raises in both packages)."""
    from repro_torch.core.pipeline import InstanceOptimizer
    from repro_torch.kernels import ops
    _, recipes = session_recipes(cfg)
    check([r.name for r in recipes] == ["w8-absmax", "w8a-ffn75", "w8a-kv50"], recipes)
    toks = calibration_tokens(device)
    sync()
    t0 = time.time()
    opt = InstanceOptimizer(base, cfg)
    st = opt.run_calibration({"tokens": toks,
                              "enc_inputs": frames.expand(toks.shape[0], *frames.shape)},
                             hessian=False)
    sync()
    calib_s = time.time() - t0
    check(st.n_tokens == toks.numel() and all(w.H is None for w in st.weights.values())
          and st.weights["dec_blocks.0.xattn.wk"].count == toks.shape[0] * cfg.enc_ctx
          and st.weights["unembed"].count == toks.numel()
          and len(st.block_sim) == cfg.n_enc_layers + cfg.n_dec_layers,
          ("encdec calibration", st.n_tokens, len(st.weights)))
    dec, pre = encdec_per_call(cfg, False), encdec_per_call(cfg, True)
    builds = []
    launches = {k: 0 for k in ops.launch_count}
    for r in recipes:
        sync()
        t0 = time.time()
        params, c, report = opt.apply(r)
        sync()
        apply_s = time.time() - t0
        ops.reset_launch_counts()
        eng, reqs = serve_extra(params, c, r.name, {"enc_inputs": frames}, ENCDEC_MAX_LEN,
                                device)
        variants = {k: n for k, n in ops.variant_count.items() if n}
        stt = eng.stats
        if device == "cuda":
            check(variants == {"quant_matmul.decode": dec["decode"] * stt.decode_steps,
                               "quant_matmul.mma": pre["mma"] * stt.prefills,
                               "quant_matmul.fma": stt.decode_steps + stt.prefills},
                  (r.name, "served designs", variants))
        for k, n in ops.launch_count.items():
            launches[k] += n
        agree, same = _agreement(base_reqs, reqs)
        builds.append({"recipe": r.name, "apply_s": apply_s, "calibrate_s": calib_s,
                       "build_s": calib_s + apply_s, "d_ff": c.d_ff, "n_heads": c.n_heads,
                       "n_kv_heads": c.n_kv_heads, "param_bytes": report.bytes_after,
                       "compression": report.compression, "rows_per_s": stt.rows_per_s,
                       "decode_steps": stt.decode_steps, "prefills": stt.prefills,
                       "greedy_token_agreement_with_base": agree, "rows_identical": same,
                       "variants": variants})
        del params, eng
    check([(b["d_ff"], b["n_kv_heads"]) for b in builds]
          == [(cfg.d_ff, cfg.n_kv_heads), (int(round(0.75 * cfg.d_ff)) // 8 * 8, cfg.n_kv_heads),
              (cfg.d_ff, cfg.n_kv_heads // 2)], ("pruned builds", builds))
    line = {"phase": "encdec_build", "model": cfg.name, "calibration_rows": list(toks.shape),
            "calibrate_s": calib_s, "builds": builds, "launches": launches}
    emit(line)
    print("whisper builds: calibrate " + f"{calib_s:.2f} s; " + "; ".join(
        f"{b['recipe']} apply {b['apply_s']:.2f} s, {b['rows_per_s']:.2f} rows/s, agreement "
        f"{b['greedy_token_agreement_with_base']:.3f}" for b in builds), flush=True)
    if device == "cuda":
        check(launches["quant_matmul"] > 0 and not (launches["paged_attention"]
                                                    or launches["flash_attention"]
                                                    or launches["block_sparse_matmul"]),
              ("encdec build launches", launches))
    return line, launches


def encdec_f32_parity(gen, cfg_full, max_new: int = 32):
    """whisper-base at full width in f32 (0.66 GB), ``w8-absmax``, seeded
    frames: the main path's rows through the engine under the cuda and
    the reference backends; rows identical, or parted at a near tie (the
    plain side's top-two logit gap at the first differing token under
    NEAR_TIE, from ``forward``)."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.models import api
    from repro_torch.training.data import ByteTokenizer
    cfg = cfg_full.replace(param_dtype="float32")
    base = api.init_params(gen, cfg)
    params, _, _ = InstanceOptimizer(base, cfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    del base
    frames = _enc_frames(gen, cfg, "cuda")
    ids, designs = _f32_engine_runs(params, cfg, {"enc_inputs": frames}, ENCDEC_MAX_LEN,
                                    max_new)
    tok = ByteTokenizer(max(cfg.vocab_size, 260))

    def gap(text, out):
        seq = tok.encode(text, bos=True) + [tok.SEP] + out
        with kernel_backend("reference"), torch.no_grad():
            lg, _ = api.forward(params, cfg, {"tokens": torch.tensor([seq], device="cuda"),
                                              "enc_inputs": frames[None]})
        top = lg[0, -1].float().topk(2).values
        return (top[0] - top[1]).item()

    across = _near_tie_rows(ids["cuda"], ids["reference"], gap)
    line = {"phase": "encdec_f32_parity", "model": cfg.name, "layers": cfg.n_layers,
            "dtype": "float32", "recipe": "w8-absmax", "prompts": len(ids["cuda"]),
            "rows_differing_across_backends": across, "near_tie_bound": NEAR_TIE,
            "designs": designs}
    emit(line)
    print(f"encdec_f32_parity: {len(across)} of {len(ids['cuda'])} rows differ across backends",
          flush=True)
    check(all(d["gap"] < NEAR_TIE for d in across), line)
    del params
    torch.cuda.empty_cache()
    return line


def check_quant_matmul_vlm_encdec(vlm_shapes, vlm_session_shapes, enc_shapes,
                                  enc_build_shapes, vlm_dims=(2048, 16384),
                                  enc_dims=(512, 51865)):
    """K2 against its plain version at every shape that the vlm path
    (``vlm_main_path``'s int8 run, ``vlm_session``) and the encdec path
    (``encdec_main_path``'s int8 run, ``encdec_build``) gave it
    (``_hold_seen``, from a generator of its own, VLM_ENCDEC_KERNEL_SEED),
    whisper's unembed on ``fma`` included.  Then times paligemma's ``wi``
    (``vlm_dims``) and whisper's unembed (``enc_dims``: N 51865, ``fma``)
    at decode M = 8 and prefill M = 512 against ``torch.matmul`` and
    their bound."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(VLM_ENCDEC_KERNEL_SEED)
    check({s[6] for s in vlm_shapes} == {"decode", "mma"},
          ("K2 designs of the vlm main path", sorted(set(vlm_shapes))))
    check({s[6] for s in enc_shapes} == {"decode", "mma", "fma"},
          ("K2 designs of the encdec main path", sorted(set(enc_shapes))))
    unembed = {s for s in set(enc_shapes) | set(enc_build_shapes) if s[1:3] == enc_dims}
    check(unembed and {s[6] for s in unembed} == {"fma"}, ("whisper's unembed on fma", unembed))
    vres, vabs = _hold_seen(gen, vlm_shapes, vlm_session_shapes, "vlm")
    eres, eabs = _hold_seen(gen, enc_shapes, enc_build_shapes, "encdec")
    timed = {f"{name}_M{M}": _time_dense(gen, M, K, N)
             for name, (K, N) in (("paligemma_wi", vlm_dims), ("whisper_unembed", enc_dims))
             for M in (8, 512)}
    results = vres + eres
    line = {"phase": "kernel_quant_matmul_vlm_encdec", "cases": results,
            "cases_vlm": len(vres), "cases_encdec": len(eres),
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": max(vabs, eabs),
            "unembed_shapes": sorted(unembed), "timed": timed,
            "library_note": "torch.matmul on the dequantized bf16 weight"}
    emit({**line, "cases": len(results)})   # each case in chip_smoke.json
    print(f"K2 at {len(vres)} vlm and {len(eres)} encdec shapes ({len(unembed)} of the unembed "
          f"on fma): max rel err {line['max_rel_err']:.3g}; " + "; ".join(
              f"{k}: {t['variant']} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, plain "
              f"{t['plain_ms']:.4f}, matmul {t['library_ms']:.4f})" for k, t in timed.items()),
          flush=True)
    return line


# ---------------------------------------------------------------------------
# the granite phases: full-width granite-20b, MQA of 48 query heads on one
# KV head, which K1 serves with its `mma` design
# ---------------------------------------------------------------------------

GRANITE_SEED = 61                # the granite phases' generator: earlier phases' draws stay
GRANITE_KERNEL_SEED = 67         # K1, K2 and K3 at granite's shapes: adding a case moves no weight
# K1 at granite's decode: 8 slots, one KV head of 48 query heads, head dim
# 128, blocks of 32 at max_len 1024; no window or softcap
GRANITE_PA = {"Kh": 1, "G": 48, "D": 128, "bs": 32, "nblk": 32}
# the granite session's depth: the ffn75 candidate's pruned bf16 wi and wo
# (23.6 GB at 52 layers) beside the base (40.6 GB) and the kept w8-absmax
# candidate (21.2 GB) outgrow the card's 80 GB, so the session serves a
# copy of the first 26 layers of the same weights, at the published widths
GRANITE_SESSION_LAYERS = 26


def _k1_planted_faults(gen, ref, ops):
    """Shows that the per-slot measure of check_paged_attention_g48 fails
    two faults of the split merge that a kernel could make, at granite's
    bf16 decode shape (plan of 11 splits of 96): the plain version's
    output with, in every slot of two or more live splits, the last live
    split's PV partial left out (``drop_last_split``), or each split's
    probabilities normalised by its own (max, sum) and the splits'
    outputs added (``split_local_softmax``); and, in the slots of 700 and
    1024 positions alone, the partial of their middle live split left out
    (``drop_middle_split_long``).  Each must be past K1_SLOT_TOL in bf16;
    the tensor-wide measure is recorded beside it."""
    lengths = [1, 33, 95, 96, 97, 193, 700, 1024]
    q, k, v, tables, ln = _paged_inputs(gen, torch.bfloat16, lengths, **GRANITE_PA)
    S, _, H, D = q.shape
    qr = q[:, 0].reshape(S, 1, H, D)
    splits, per = ops.paged_attention_plan(S, 1, 1024, 0, 32, 2 * H)
    want = ref.paged_attention(qr.float(), k, v, tables, ln)
    T = tables.shape[1] * k.shape[1]
    kk = k[tables.long()].reshape(S, T, 1, D).float()
    vv = v[tables.long()].reshape(S, T, 1, D).float()
    sc = torch.einsum("skgd,stkd->skgt", qr.float(), kk) / math.sqrt(D)
    t = torch.arange(T, device="cuda")[None, :]
    n = ln.long()[:, None]
    sc = sc.masked_fill(~(t < n)[:, None, None], -math.inf)
    p = torch.softmax(sc, -1)
    multi = n > per                              # two or more live splits
    last = (t >= (n - 1) // per * per) & multi   # the last live split's positions
    drop = p.masked_fill(last[:, None, None], 0.0)
    mid = ((n - 1) // per + 1) // 2 * per
    middle = (t >= mid) & (t < mid + per) & (n >= 700)
    drop_mid = p.masked_fill(middle[:, None, None], 0.0)
    sz = torch.nn.functional.pad(sc, (0, splits * per - T), value=-math.inf)
    sz = sz.reshape(S, 1, H, splits, per)
    e = torch.exp(sz - sz.amax(-1, keepdim=True).clamp(min=-1e30))
    local = (e / e.sum(-1, keepdim=True).clamp(min=1e-30)).reshape(S, 1, H, -1)[..., :T]
    local = torch.where(multi[:, None, None], local, p)
    out = {}
    for name, probs in (("drop_last_split", drop), ("split_local_softmax", local),
                        ("drop_middle_split_long", drop_mid)):
        got = torch.einsum("skgt,stkd->skgd", probs.to(torch.bfloat16).float(), vv)
        got = got.to(torch.bfloat16)
        out[name] = {"rel_err": slot_errors(got, want)[1],
                     "tensor_rel_err": errors(got, want.to(torch.bfloat16))[1]}
        check(out[name]["rel_err"] > K1_SLOT_TOL[torch.bfloat16], ("planted fault passes",
                                                                  name, out[name]))
    return out


def check_paged_attention_g48():
    """K1 at granite's MQA (8 slots, one KV head, D 128, blocks of 32)
    against its plain version: G 48 and, around the 8-row boundary of the
    ``split`` design, G 9, 16 and 24; tables of 128 and 1024 positions with
    lengths around the split edges (1 to 1024), plain and aliased tables,
    bf16 (``mma``) and f32 (``chunked``); a window and a softcap at G 48;
    bf16 at G 72 (``chunked``, past the ``mma`` design's 64 rows).  At G 8
    ``mma`` (bf16) and ``chunked`` (f32) run beside ``split`` on the same
    inputs, and each must agree with the plain version and with ``split``.
    Every output is held per slot (:func:`slot_errors`, K1_SLOT_TOL), and
    two planted faults of the split merge must fail that measure
    (:func:`_k1_planted_faults`).  Then one bf16 decode call at G 48 is
    timed at 128 and 1024 positions a slot."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(GRANITE_KERNEL_SEED)
    # mma's splits are 96 positions at G 48 (min_per 2 G), 64 at G 24, else 32
    ragged = {4: [1, 31, 32, 33, 64, 96, 97, 128],
              32: [1, 33, 95, 96, 97, 193, 700, 1024]}
    cases = [(dtype, G, nblk, lengths, alias, 0, 0.0)
             for dtype in (torch.bfloat16, torch.float32) for G in (48, 9, 16, 24)
             for nblk, lengths in ragged.items() for alias in (False, True)]
    cases += [(dtype, 48, 32, ragged[32], True, 64, 50.0)
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [(torch.bfloat16, 72, 4, ragged[4], False, 0, 0.0)]
    worst_abs, results = 0.0, []

    def hold(got, want, dtype, rec):
        """got against the plain version's f32 output ``want``, per slot
        (K1_SLOT_TOL); ``tensor_rel_err`` is the tensor-wide measure of
        the other K1 phases, for comparison."""
        nonlocal worst_abs
        err_abs, err_rel = slot_errors(got, want)
        rec["rel_err"] = err_rel
        rec["tensor_rel_err"] = errors(got, want.to(dtype))[1]
        results.append(rec)
        check(got.dtype == dtype and bool(torch.isfinite(got).all())
              and err_rel < K1_SLOT_TOL[dtype], rec)
        worst_abs = max(worst_abs, err_abs)

    for dtype, G, nblk, lengths, alias, window, cap in cases:
        shape = {**GRANITE_PA, "G": G, "nblk": nblk, "alias": alias}
        q, k, v, tables, ln = _paged_inputs(gen, dtype, lengths, **shape)
        variant = ops.paged_attention_variant(dtype, G)
        before = dict(ops.variant_count)
        got = ops.paged_attention(q, k, v, tables, ln, softcap=cap, window=window)
        S, _, H, D = q.shape
        want = ref.paged_attention(q[:, 0].reshape(S, 1, G, D).float(), k, v, tables, ln,
                                   softcap=cap, window=window).reshape(S, 1, H, D)
        torch.cuda.synchronize()
        check(variant_delta(before) == {f"paged_attention.{variant}": 1},
              ("K1 design", G, dtype, variant_delta(before)))
        hold(got, want, dtype, {"dtype": str(dtype).split(".")[-1], "G": G, "lengths": lengths,
                                "window": window, "softcap": cap, "variant": variant,
                                "plan": ops.paged_attention_plan(
                                    S, 1, nblk * 32, window, 32,
                                    2 * G if variant == "mma" else 0), **shape})
    # G 8: the rule picks `split`; `mma` (bf16) and `chunked` (f32, one
    # chunk of 8) take the same inputs
    agree = {}
    for dtype, other in ((torch.bfloat16, "mma"), (torch.float32, "chunked")):
        for nblk, lengths in ragged.items():
            q, k, v, tables, ln = _paged_inputs(gen, dtype, lengths,
                                                **{**GRANITE_PA, "G": 8, "nblk": nblk})
            qr = q[:, 0].reshape(8, 1, 8, 128)
            before = dict(ops.variant_count)
            a = ops.paged_attention(q, k, v, tables, ln).reshape(qr.shape)
            b = ops._launch_paged_attention(qr, k, v, tables, ln, 0.0, 0, other)
            want = ref.paged_attention(qr.float(), k, v, tables, ln)
            torch.cuda.synchronize()
            check(variant_delta(before) == {"paged_attention.split": 1,
                                            f"paged_attention.{other}": 1},
                  ("K1 designs at G 8", variant_delta(before)))
            for name, got in (("split", a), (other, b)):
                hold(got, want, dtype, {"dtype": str(dtype).split(".")[-1], "G": 8,
                                        "lengths": lengths, "variant": name, "nblk": nblk})
            key = f"{str(dtype).split('.')[-1]}_{nblk * 32}"
            # each is within K1_SLOT_TOL of want, so the two within twice that
            agree[key] = slot_errors(b, a)[1]
            check(agree[key] < 2 * K1_SLOT_TOL[dtype],
                  ("split and", other, "differ at G 8", agree))
    planted = _k1_planted_faults(gen, ref, ops)

    timed = {}
    for L in (128, 1024):
        lengths = [L] * 8
        q, k, v, tables, ln = _paged_inputs(gen, torch.bfloat16, lengths, **GRANITE_PA)
        S, _, H, D = q.shape
        qr = q[:, 0].reshape(S, 1, H, D)
        ms = time_ms(lambda: ops.paged_attention(q, k, v, tables, ln))
        plain_ms = time_ms(lambda: ref.paged_attention(qr, k, v, tables, ln))
        # one KV head: the 48 query heads are 48 query rows of one SDPA head
        kc = k[tables.long()].reshape(S, -1, 1, D)[:, :L].permute(0, 2, 1, 3).contiguous()
        vc = v[tables.long()].reshape(S, -1, 1, D)[:, :L].permute(0, 2, 1, 3).contiguous()
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qr, kc, vc))
        nbytes = sum(lengths) * D * 2 * 2 + 2 * q.numel() * 2 + tables.numel() * 4 + S * 4
        flops = sum(lengths) * H * D * 2 * 2
        bound_ms, bound_by = bound(nbytes, flops)
        timed[L] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
                    "bytes": nbytes, "flops": flops,
                    "plan": ops.paged_attention_plan(S, 1, 1024, 0, 32, 2 * H)}
    line = {"phase": "kernel", "name": "paged_attention_g48", "cases": len(results),
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "measure": "per slot: a slot's max abs error over its own max |want|, want the "
                       "plain version's f32 output", "tolerance": {
                           str(d).split(".")[-1]: t for d, t in K1_SLOT_TOL.items()},
            "g8_rel_to_split": agree, "planted_faults": planted,
            "timed": "one granite decode call, S=8 Kh=1 G=48 D=128 bs=32, 128 positions a "
                     "slot, bf16 (1024 positions under L1024)",
            "variant": ops.paged_attention_variant(torch.bfloat16, 48), **timed[128],
            "L1024": timed[1024],
            "library_note": "SDPA on K/V gathered beforehand, the 48 query heads as 48 rows "
                            "of one head"}
    emit(line)
    print(f"K1 at G 48: {len(results)} cases, max rel err per slot {line['max_rel_err']:.3g} "
          f"(tensor-wide {max(r['tensor_rel_err'] for r in results):.3g}); planted faults "
          + ", ".join(f"{n} {f['rel_err']:.3g} (tensor-wide {f['tensor_rel_err']:.3g})"
                      for n, f in planted.items()) + "; "
          + "; ".join(f"{L} positions {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, plain "
                      f"{t['plain_ms']:.4f}, SDPA {t['library_ms']:.4f})"
                      for L, t in timed.items()), flush=True)
    return line, results


def check_flash_attention_g48():
    """K3 at granite's head layout (48 query heads on one KV head, D 128)
    against its plain version: the prefill of a 4096-token document (S = T
    = 4096), a ragged ``t_real``, and tile edges (S of 127 and 129, T not a
    multiple of the 64-key stage, a window, q_offset), bf16 (``mma``) and
    f32 (``fma``).  Then the 4096-token call is timed in bf16."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(GRANITE_KERNEL_SEED + 1)
    # (B, S, T, H, Kh, D, window, softcap, q_offset, t_real)
    shapes = [(1, 4096, 4096, 48, 1, 128, 0, 0.0, 0, 0),
              (1, 4096, 4096, 48, 1, 128, 0, 0.0, 0, 4001),
              (2, 127, 127, 48, 1, 128, 0, 0.0, 0, 0),
              (1, 129, 300, 48, 1, 128, 70, 0.0, 171, 290)]
    worst_abs, results = 0.0, []
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, T, H, Kh, D, win, cap, off, t_real in shapes:
            q, k, v = _attn_inputs(gen, B, S, T, H, Kh, D, dtype)
            kw = dict(causal=True, window=win, softcap=cap, q_offset=off, t_real=t_real)
            before = dict(ops.variant_count)
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == q.shape, ("output", got.shape))
            check(variant_delta(before) == {f"flash_attention.{ops.flash_variant(dtype)}": 1},
                  ("K3 design", variant_delta(before)))
            err_abs, err_rel = errors(got, want)
            results.append({"B": B, "S": S, "T": T, "H": H, "Kh": Kh, "D": D,
                            "window": win, "softcap": cap, "q_offset": off,
                            "t_real": t_real, "dtype": str(dtype).split(".")[-1],
                            "rel_err": err_rel, "variant": ops.flash_variant(dtype)})
            check(bool(torch.isfinite(got).all()) and err_rel < K34_TOL[dtype], results[-1])
            worst_abs = max(worst_abs, err_abs)
            del q, k, v, got, want
    B, S, H, D = 1, 4096, 48, 128
    q, k, v = _attn_inputs(gen, B, S, S, H, 1, D, torch.bfloat16)
    t = {"ms": time_ms(lambda: ops.flash_attention(q, k, v, causal=True), reps=10),
         "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v, causal=True), reps=3)}
    qs = q.transpose(1, 2).contiguous()
    ks = k.transpose(1, 2).repeat_interleave(H, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(H, dim=1).contiguous()
    t["library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True), reps=10)
    t["flops"] = 4.0 * B * H * D * (S * (S + 1) / 2)
    t["bound_ms"], t["bound_by"] = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                                         t["flops"])
    t["bound_share"] = t["bound_ms"] / t["ms"]
    line = {"phase": "kernel", "name": "flash_attention_g48", "cases": len(results),
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "timed": "granite's prefill attention of one layer, B=1 S=T=4096 H=48 Kh=1 "
                     "D=128, causal, bf16", "variant": ops.flash_variant(torch.bfloat16),
            "library_note": "SDPA is_causal, the KV head pre-expanded to 48", **t}
    emit(line)
    print(f"K3 at granite's layout: {len(results)} cases, max rel err "
          f"{line['max_rel_err']:.3g}; {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, plain "
          f"{t['plain_ms']:.4f}, SDPA {t['library_ms']:.4f})", flush=True)
    return line, results


def granite_per_call(cfg):
    """(K2, K1) launches of one model call of granite's int8 instance: each
    layer's six linears (wq, wk, wv, attn wo; the ungated MLP's wi and wo)
    and the untied, quantized unembed; K1 once a layer in a decode step."""
    return 6 * cfg.n_layers + 1, cfg.n_layers


def _k1_design(cfg, dtype=torch.bfloat16):
    from repro_torch.kernels import ops
    return f"paged_attention.{ops.paged_attention_variant(dtype, cfg.n_heads // cfg.n_kv_heads)}"


def granite_main_path(gen, cfg=None, device="cuda"):
    """Full-width granite-20b (52 layers, d_model 6144, 48 query heads on one
    KV head of 128, an ungated GELU MLP of 24576, vocab 49152, untied;
    20,315,111,424 params, 20,315,756,544 with the norms' weights, random
    bf16 weights from ``gen``) compressed with ``w8-absmax`` and served by
    ``Engine(slots=8, max_len=1024)`` (paged) on the main path's rows and
    template, then the bf16 base the same way: per decode step 313 K2
    launches on ``decode`` and 52 of K1, all on its
    ``mma`` design; per prefill 313 on ``mma``; no K3 or K4.  The base run
    launches K1 alone.  ``cfg`` and ``device`` let it run at reduced widths
    on the CPU."""
    from repro_torch.configs import granite_20b
    from repro_torch.core.compressed import param_bytes
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import decode_step_cost
    from repro_torch.models import api
    from repro_torch.serving.scheduler import slot_state_bytes
    from repro_torch.tree import leaves

    cfg = cfg or granite_20b.CONFIG
    k2, k1 = granite_per_call(cfg)
    k1_design = _k1_design(cfg)
    t0 = time.time()
    base = api.init_params(gen, cfg)
    sync()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in leaves(base))
    if cfg == granite_20b.CONFIG:         # param_count() leaves out the 105 norms' weights
        check(n_params == 20_315_756_544 and cfg.param_count() == 20_315_111_424,
              ("granite params", n_params, cfg.param_count()))
    t0 = time.time()
    int8, _, report = InstanceOptimizer(base, cfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    sync()
    quant_s = time.time() - t0
    check(getattr(int8["unembed"], "q", None) is not None, "the untied unembed is quantized")

    reset_peak()
    ops.reset_launch_counts()
    eng8, reqs8 = serve(int8, cfg, "w8-absmax", device)
    launches = dict(ops.launch_count)
    variants = {k: n for k, n in ops.variant_count.items() if n}
    st8 = eng8.stats
    check(eng8._paged and eng8._block_size == 32, ("granite serves paged KV", eng8._block_size))
    if device == "cuda":
        check(launches == {"quant_matmul": k2 * (st8.decode_steps + st8.prefills),
                           "paged_attention": k1 * st8.decode_steps,
                           "block_sparse_matmul": 0, "flash_attention": 0},
              ("granite int8 run launches", launches, st8.decode_steps, st8.prefills))
        check(variants == {"quant_matmul.decode": k2 * st8.decode_steps,
                           "quant_matmul.mma": k2 * st8.prefills,
                           k1_design: k1 * st8.decode_steps},
              ("granite int8 run designs", variants))
    peak8 = card_memory()[1]
    ops.reset_launch_counts()
    eng16, reqs16 = serve(base, cfg, "base", device)
    base_launches = dict(ops.launch_count)
    base_variants = {k: n for k, n in ops.variant_count.items() if n}
    if device == "cuda":
        check(base_launches["quant_matmul"] == 0 and base_launches["paged_attention"] > 0
              and base_variants == {k1_design: base_launches["paged_attention"]},
              ("granite base run", base_launches, base_variants))
    agree, rows_same = _agreement(reqs16, reqs8)
    line = {"phase": "granite_main_path", "model": cfg.name, "params": n_params,
            "layers": cfg.n_layers, "layout": "paged", "block_size": eng8._block_size,
            "slot_state_bytes": slot_state_bytes(cfg, 1024),
            "rows": len(REVIEWS), "max_new": 32, "init_s": init_s, "quantize_s": quant_s,
            "param_bytes_base": param_bytes(base), "param_bytes_int8": param_bytes(int8),
            "param_count": cfg.param_count(), "compression": report.compression,
            # the step's bytes at its first decode position (launch/roofline.py)
            "byte_floor_ms_int8": decode_step_cost(int8, cfg, eng8.slots, eng8.max_len,
                                                   positions=1).t_memory * 1e3,
            "byte_floor_ms_base": decode_step_cost(base, cfg, eng8.slots, eng8.max_len,
                                                   positions=1).t_memory * 1e3,
            "int8": {**_serve_stats(eng8, []), "launches": launches, "variants": variants},
            "base": {**_serve_stats(eng16, []), "launches": base_launches,
                     "variants": base_variants},
            "launches_per_call": {"quant_matmul": k2, "paged_attention": k1},
            "max_memory_allocated_int8_run": peak8, "max_memory_allocated": card_memory()[1],
            "greedy_token_agreement_base_vs_int8": agree,
            "rows_identical_base_vs_int8": rows_same}
    emit(line)
    for name in ("int8", "base"):
        print(f"granite {name}: {line[name]['rows_per_s']:.3f} rows/s, "
              f"{line[name]['tokens_per_s']:.1f} tokens/s, {line[name]['decode_steps']} steps, "
              f"{line[name]['prefills']} prefills", flush=True)
    print(f"granite params {n_params}, param_bytes base {line['param_bytes_base']}, int8 "
          f"{line['param_bytes_int8']}; quantize {quant_s:.1f} s; max_memory_allocated "
          f"{line['max_memory_allocated']}", flush=True)
    del eng16
    return line, launches, base, int8, eng8


def granite_session(base, cfg, device="cuda", n_rows: int = 64):
    """An ``IOLMSession`` over granite-20b's weights (on the card, a copy of
    their first GRANITE_SESSION_LAYERS layers, ``cut_depth``; that constant
    says why) runs Q2 (``llm_correct`` over ``n_rows`` values) through
    ``Query.run`` (``_family_session``): the operator calibrates on its rows
    (``wi`` with no ``wg``; no Hessian), builds and evaluates ``w8-absmax``
    and ``w8a-ffn75`` (d_ff 18432; the grid has no ``w8-kv50`` for one KV
    head) and serves the pick through the paged ``Engine``: K2 on 6 linears
    a layer and the unembed, K1 once a layer in each decode step on
    ``mma``."""
    _, recipes = session_recipes(cfg)
    check([r.name for r in recipes] == ["w8-absmax", "w8a-ffn75"], recipes)
    k2, k1 = granite_per_call(cfg)
    k1_design = _k1_design(cfg)
    pruned = int(round(0.75 * cfg.d_ff)) // 8 * 8
    calibrated = []

    def on_outcome(optimizer, out):
        st = optimizer.stats
        check(all(w.H is None for w in st.weights.values()), "a Hessian was calibrated")
        check(not any(k.endswith(".wg") for k in st.weights)
              and any(k.endswith(".wi") for k in st.weights),
              ("ungated MLP statistics", sorted(st.weights)))
        calibrated.append({"tokens": st.n_tokens, "weights": len(st.weights),
                           "configs": [(c.recipe.name, c.cfg.d_ff, c.cfg.n_kv_heads)
                                       for c in out.candidates]})
        check([(c.cfg.d_ff, c.cfg.n_kv_heads) for c in out.candidates]
              == [(cfg.d_ff, 1), (pruned, 1)], ("pruned candidates", calibrated[-1]))

    def served_gate(name, search, served, n_steps, calls):
        # a prefill of at most DECODE_M rows (a short template prefix's)
        # runs K2's `decode` design too
        check(served.get("quant_matmul.decode", 0) + served.get("quant_matmul.mma", 0)
              == k2 * calls and served.get("quant_matmul.decode", 0) >= k2 * n_steps
              and served.get(k1_design) == k1 * n_steps
              and set(served) <= {"quant_matmul.decode", "quant_matmul.mma", k1_design},
              (name, "served launches", served, n_steps, calls))

    line, launches = _family_session("granite_session", "granite", base, cfg, recipes,
                                     on_outcome, served_gate, device, n_rows, queries=("Q2",))
    line["layers"] = cfg.n_layers
    line["calibrated"] = calibrated
    emit(line)
    if device == "cuda":
        check(launches["quant_matmul"] > 0 and launches["paged_attention"] > 0
              and not (launches["flash_attention"] or launches["block_sparse_matmul"]),
              ("granite session launches", launches))
    return line, launches


def check_quant_matmul_granite(main_shapes, session_shapes, d_model=6144, d_ff=24576,
                               vocab=49152):
    """K2 against its plain version at every shape that ``granite_main_path``
    (its int8 run) and ``granite_session`` gave it (``_hold_seen``, from a
    generator of its own), on the design each launch there ran; then times
    the MLP's ``wi`` (``d_model`` -> ``d_ff``) and the untied unembed
    (``d_model`` -> ``vocab``) at M = 8 (decode) and 512 (prefill)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(GRANITE_KERNEL_SEED + 2)
    check({s[6] for s in main_shapes} == {"decode", "mma"},
          ("K2 designs of the granite main path", sorted(set(main_shapes))))
    results, worst_abs = _hold_seen(gen, main_shapes, session_shapes, "granite")
    timed = {f"{name}_M{M}": _time_dense(gen, M, d_model, N)
             for name, N in (("wi", d_ff), ("unembed", vocab)) for M in (8, 512)}
    line = {"phase": "kernel_quant_matmul_granite", "cases": results,
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "M_main_path": sorted({s[0] for s in main_shapes}),
            "M_session": sorted({s[0] for s in session_shapes}),
            "timed": timed, "library_note": "torch.matmul on the dequantized bf16 weight"}
    emit({**line, "cases": len(results)})   # each case in chip_smoke.json
    print(f"K2 at {len(results)} shapes of the granite path: max rel err "
          f"{line['max_rel_err']:.3g}; " + "; ".join(
              f"{k} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, plain {t['plain_ms']:.4f}, "
              f"matmul {t['library_ms']:.4f})" for k, t in timed.items()), flush=True)
    return line


# ---------------------------------------------------------------------------
# phase long_decode: full-width gemma3-1b over the compact local-window cache
# ---------------------------------------------------------------------------

LONG_DECODE_SEED = 101           # the phase's generator: earlier phases' draws stay
LONG_DECODE_PROMPT = 8192        # a multiple of the window (512) and of 1024
LONG_DECODE_STEPS = 16
# compact against absolute in f32: the whole-step rule's RMS bound, and the
# same bound on the largest |diff| over the largest |logit|
LONG_DECODE_F32_TOL = STEP_TOL_F32
# the int8 instance's compact bf16 logits against its absolute bf16 ones,
# fed the same tokens: RMS over the RMS of the absolute ones.  The layouts
# differ only in the attention's slots, and read 0.0685 apart on an H100;
# the whole-step rule's ratio (their distances from the f32 run's, 0.95
# each on these random weights) cannot see a fault of that size
LONG_DECODE_BF16_LAYOUT_TOL = 0.2
# one row's K/V at the reference's long_500k shape in bf16: 4 global layers at
# 524,288 positions and 22 local ones at 512, against all 26 at 524,288
LONG_DECODE_BYTES = {True: 2_159_017_984, False: 13_958_643_712}


def kv_bytes(cfg, max_len: int, compact: bool, itemsize: int) -> int:
    """One row's K/V bytes: a local layer keeps min(window, max_len) slots
    in the compact layout, every other layer ``max_len``."""
    slots = sum(min(cfg.window_size, max_len) if kind == "L" and compact else max_len
                for kind in cfg.pattern())
    return slots * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * itemsize


def long_decode_launches(cfg=None, steps: int = LONG_DECODE_STEPS):
    """The launches ``long_decode`` makes: K3 on every layer of its six
    prefills (the f32 base on both layouts, the bf16 base, the int8
    instance's f32 copy and its two bf16 layouts), K2 on the int8
    instance's seven linears a layer in each of its three prefills and
    their steps; K1 and K4 none."""
    from repro_torch.configs import gemma3_1b
    cfg = cfg or gemma3_1b.CONFIG
    return {"paged_attention": 0, "block_sparse_matmul": 0,
            "flash_attention": 6 * cfg.n_layers,
            "quant_matmul": 3 * 7 * cfg.n_layers * (1 + steps)}


def long_decode(cfg=None, device="cuda", prompt: int = LONG_DECODE_PROMPT,
                steps: int = LONG_DECODE_STEPS, max_len=None, keep: bool = False):
    """gemma3-1b at its published widths (random weights from LONG_DECODE_SEED)
    at the reference's ``long_500k`` decode shape: one row, ``max_len``
    524,288.  A prompt of ``prompt`` equal-length tokens is prefilled with
    ``use_flash=True`` (K3 on every layer) through ``api.build_prefill_step``,
    then ``steps`` tokens are decoded through ``api.build_serve_step``, once
    over the compact cache (``compact_local=True``: 22 local layers at 512
    slots) and once over the absolute one, each layout's cache freed before
    the next is built:

    - the f32 base: the prefill's last logits identical bit for bit
      between the layouts (the layout changes no prefill arithmetic),
      greedy tokens identical, the steps' logits within
      LONG_DECODE_F32_TOL in RMS and in the largest |diff| over the
      largest |logit|; the bf16 base on the compact layout, fed the same
      tokens, gives the bf16 noise on these random weights beside it;
    - the ``w8-absmax`` instance (K2 on every linear): its f32 copy on the
      absolute layout decodes greedily, and both bf16 layouts are fed the
      same tokens; the compact bf16 logits are held to the absolute ones
      (RMS within LONG_DECODE_BF16_LAYOUT_TOL, every greedy token the
      same) and to the whole-step rule (their RMS distance from the f32
      run's within STEP_BF16_RATIO of the absolute bf16 run's);
    - every cache's bytes equal ``kv_bytes`` (LONG_DECODE_BYTES in bf16),
      each run's ``max_memory_allocated`` recorded.

    Every run is on the cuda backend; the launches are read by the caller.
    With ``keep`` it also returns what ``seq_split_decode`` decodes from:
    the f32 base and the int8 instance, each one's compact cache as its
    prefill left it, the tokens each compact run was fed and its logits
    (so the peaks recorded include the kept caches)."""
    from repro_torch.configs import gemma3_1b
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.launch.dryrun import SHAPES
    from repro_torch.launch.roofline import ShapeSpec
    from repro_torch.models import api
    from repro_torch.tree import flatten_with_path, tree_map
    cfg = cfg or gemma3_1b.CONFIG
    spec = SHAPES["long_500k"]
    if max_len is not None:
        spec = ShapeSpec(spec.name, max_len, spec.global_batch, spec.kind)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
               cfg.d_ff, cfg.vocab_size, cfg.window_size, spec.seq_len, spec.global_batch)
              == (26, 1152, 4, 1, 256, 6912, 262144, 512, 524288, 1),
              ("long_decode runs gemma3-1b's published widths at long_500k", cfg))
        check(all(kv_bytes(cfg, spec.seq_len, c, 2) == n for c, n in LONG_DECODE_BYTES.items()),
              ("the analytic K/V bytes", LONG_DECODE_BYTES))
    gen = torch.Generator(device=device)
    gen.manual_seed(LONG_DECODE_SEED)
    base = api.init_params(gen, cfg)
    toks = torch.randint(4, cfg.vocab_size, (1, prompt), generator=gen, device=device)
    rms = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run(params, c, compact, feed=None):
        """Prefill and ``steps`` decode steps: greedy, or fed ``feed``."""
        reset_peak()
        sync()
        t0 = time.time()
        with kernel_backend("cuda"), torch.no_grad():
            last, cache = api.build_prefill_step(c, spec, compact_local=compact,
                                                 use_flash=True)(params, {"tokens": toks})
            sync()
            t_prefill = time.time() - t0
            prefilled = tree_map(torch.clone, cache) if keep and compact else None
            nbytes = sum(t.numel() * t.element_size() for _, t in flatten_with_path(cache))
            serve = api.build_serve_step(c, spec)
            logits = [last[:, -1].float()]
            tok = last[:, -1].argmax(-1).to(torch.int32)[:, None]
            fed = []
            t1 = time.time()
            for i in range(steps):
                if feed is not None:
                    tok = feed[i].view(1, 1)
                fed.append(tok.view(1))
                tok, lg, cache = serve(params, cache, tok,
                                       torch.full((1,), prompt + i, dtype=torch.long,
                                                  device=device))
                logits.append(lg[:, -1].float())
            sync()
            t_decode = time.time() - t1
        del cache
        if cuda:
            torch.cuda.empty_cache()
        logits = torch.cat(logits)
        check(bool(torch.isfinite(logits).all()) and logits.shape == (steps + 1, cfg.vocab_size),
              ("long_decode logits", c.param_dtype, compact, logits.shape))
        want = kv_bytes(c, spec.seq_len, compact, torch.empty((), dtype=c.dtype).element_size())
        check(nbytes == want, ("long_decode cache bytes", c.param_dtype, compact, nbytes, want))
        return {"logits": logits, "fed": torch.cat(fed), "greedy": logits.argmax(-1),
                "cache_bytes": nbytes, "max_memory_allocated": card_memory()[1],
                "prefill_s": t_prefill, "decode_ms_per_step": t_decode / steps * 1e3,
                "prefilled": prefilled}

    def summary(r):
        return {k: r[k] for k in ("cache_bytes", "max_memory_allocated", "prefill_s",
                                  "decode_ms_per_step")}

    # the f32 base: greedy on each layout
    c32 = cfg.replace(param_dtype="float32")
    p32 = _f32(base)
    f32 = {compact: run(p32, c32, compact) for compact in (True, False)}
    kept = {"f32": {"params": p32, "cfg": c32}} if keep else {}
    del p32
    same_tokens = torch.equal(f32[True]["greedy"], f32[False]["greedy"])
    same_prefill = torch.equal(f32[True]["logits"][0], f32[False]["logits"][0])
    f32_diff = ((f32[True]["logits"] - f32[False]["logits"]).abs().max()
                / f32[False]["logits"].abs().max()).item()
    f32_rms = rms(f32[True]["logits"], f32[False]["logits"])
    b16 = run(base, cfg, True, feed=f32[False]["fed"])
    base_noise = {"bf16_vs_f32": rms(b16["logits"], f32[False]["logits"]),
                  "token_agreement": (b16["greedy"] == f32[False]["greedy"]).float().mean().item()}
    # the w8-absmax instance: its f32 copy on the absolute layout decodes greedily
    int8, _, _ = InstanceOptimizer(base, cfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    del base
    i32 = _f32(int8)
    ref = run(i32, c32, False)
    del i32
    bf16 = {compact: run(int8, cfg, compact, feed=ref["fed"]) for compact in (True, False)}
    if keep:
        kept["bf16"] = {"params": int8, "cfg": cfg}
    del int8
    if cuda:
        torch.cuda.empty_cache()
    r32 = ref["logits"]
    c16, a16 = bf16[True]["logits"], bf16[False]["logits"]
    line = {"phase": "long_decode", "model": cfg.name, "batch": spec.global_batch,
            "max_len": spec.seq_len, "prompt": prompt, "steps": steps,
            "window": cfg.window_size, "local_layers": cfg.pattern().count("L"),
            "f32": {"greedy_identical": same_tokens, "prefill_logits_identical": same_prefill,
                    "max_rel_logit_diff": f32_diff, "rms_rel_diff": f32_rms,
                    "bound": LONG_DECODE_F32_TOL, "compact": summary(f32[True]),
                    "absolute": summary(f32[False])},
            "bf16_base_compact": {**base_noise, **summary(b16)},
            "w8_absmax_bf16": {
                "compact_vs_f32": rms(c16, r32), "absolute_vs_f32": rms(a16, r32),
                "ratio": rms(c16, r32) / rms(a16, r32), "ratio_bound": STEP_BF16_RATIO,
                "compact_vs_absolute": rms(c16, a16),
                "compact_vs_absolute_bound": LONG_DECODE_BF16_LAYOUT_TOL,
                "token_agreement_compact_absolute":
                    (c16.argmax(-1) == a16.argmax(-1)).float().mean().item(),
                "token_agreement_compact_f32":
                    (c16.argmax(-1) == r32.argmax(-1)).float().mean().item(),
                "token_agreement_absolute_f32":
                    (a16.argmax(-1) == r32.argmax(-1)).float().mean().item(),
                "compact": summary(bf16[True]), "absolute": summary(bf16[False]),
                "f32_absolute": summary(ref)},
            "cache_bytes_ratio": bf16[False]["cache_bytes"] / bf16[True]["cache_bytes"]}
    emit(line)
    q = line["w8_absmax_bf16"]
    print(f"long_decode {cfg.name} B 1 max_len {spec.seq_len}: K/V bytes compact "
          f"{bf16[True]['cache_bytes']} against absolute {bf16[False]['cache_bytes']} (bf16, "
          f"{line['cache_bytes_ratio']:.3f}x); f32 greedy identical {same_tokens}, prefill "
          f"identical {same_prefill}, max rel logit diff {f32_diff:.3e}, RMS {f32_rms:.3e} "
          f"(bound {LONG_DECODE_F32_TOL}); bf16 base against f32 RMS "
          f"{base_noise['bf16_vs_f32']:.3f}, agreement {base_noise['token_agreement']:.3f}; "
          f"int8 bf16 RMS ratio "
          f"{q['ratio']:.4f} (bound {STEP_BF16_RATIO}), compact against absolute RMS "
          f"{q['compact_vs_absolute']:.4f} (bound {LONG_DECODE_BF16_LAYOUT_TOL}), token "
          f"agreement {q['token_agreement_compact_absolute']:.3f}; bf16 decode "
          f"{bf16[True]['decode_ms_per_step']:.2f} ms/step compact, "
          f"{bf16[False]['decode_ms_per_step']:.2f} absolute; peaks "
          f"{bf16[True]['max_memory_allocated']} and {bf16[False]['max_memory_allocated']}",
          flush=True)
    check(same_tokens and same_prefill, ("long_decode f32 greedy tokens and prefill", line))
    check(f32_diff < LONG_DECODE_F32_TOL and f32_rms < LONG_DECODE_F32_TOL,
          ("long_decode f32 logits", line))
    check(q["compact_vs_absolute"] < LONG_DECODE_BF16_LAYOUT_TOL
          and q["token_agreement_compact_absolute"] == 1.0,
          ("long_decode bf16 compact against absolute", line))
    check(q["ratio"] <= STEP_BF16_RATIO, ("long_decode bf16 whole-step rule", line))
    if not keep:
        return line
    for which, r in (("f32", f32[True]), ("bf16", bf16[True])):
        kept[which].update(cache=r["prefilled"], fed=r["fed"], logits=r["logits"],
                           decode_ms_per_step=r["decode_ms_per_step"])
    kept["bf16"]["f32_logits"] = r32
    return line, {**kept, "spec": spec, "prompt": prompt, "steps": steps}


# ---------------------------------------------------------------------------
# phase seq_split_decode: long_decode's compact caches split along their positions
# ---------------------------------------------------------------------------

# (data, model) meshes whose positions are all one card: the production cell's
# own combination (positions over "data", head_dim over "model") and positions
# over 4
SEQ_SPLIT_MESHES = ((2, 2), (4, 1))
# a quarter of the compact cache's 2,159,017,984 B of bf16 K/V at every position
# of either mesh: each splits every k/v leaf in 4 (a local layer's 512 slots in
# pieces of 256 or 128, a global one's 524,288 in pieces of 262,144 or 131,072)
SEQ_SPLIT_BYTES = 539_754_496


def seq_split_decode_launches(cfg=None, steps: int = LONG_DECODE_STEPS,
                              meshes=SEQ_SPLIT_MESHES):
    """The launches ``seq_split_decode`` makes: K2 on every linear piece of
    the int8 instance's bf16 steps at each mesh (at "model" size M,
    ``wq``, the attention's ``wo``, ``wi``, ``wg`` and the MLP's ``wo`` in
    M pieces, ``wk`` and ``wv`` whole: gemma3-1b's one KV head does not
    divide M), twice where M > 1 (the placed cache's steps, and the same
    placed params' over the unplaced cache); no prefill, so no K3; the
    f32 base runs no kernel; K1 and K4 none."""
    from repro_torch.configs import gemma3_1b
    cfg = cfg or gemma3_1b.CONFIG
    return {"paged_attention": 0, "block_sparse_matmul": 0, "flash_attention": 0,
            "quant_matmul": steps * cfg.n_layers * sum((5 * m + 2) * (1 + (m > 1))
                                                       for _, m in meshes)}


def seq_split_decode(kept, device="cuda", meshes=SEQ_SPLIT_MESHES):
    """gemma3-1b at ``long_500k`` over its cache split along the positions
    (the reference's sequence parallelism: one row, which "data" cannot
    split): ``long_decode``'s compact caches as their prefills left them
    (``long_decode(keep=True)``), cloned and placed by ``place_slot_state``
    on each (data, model) mesh of ``meshes`` whose positions are all on
    ``device``, the params placed by ``shard_params``, then the same steps
    through ``api.build_serve_step``:

    - the f32 base, greedy: every token that of long_decode's compact f32
      run, the logits within LONG_DECODE_F32_TOL of its (the largest
      |diff| over the largest |logit|, and RMS);
    - the ``w8-absmax`` instance in bf16 (K2 on every linear piece), fed
      long_decode's tokens, held to the same placed params' steps over the
      unplaced compact cache (long_decode's own run where "model" splits
      nothing): RMS within LONG_DECODE_BF16_LAYOUT_TOL, and every step
      whose greedy token parts a near tie of the unplaced run's logits
      (NEAR_TIE_SIGMAS, as ``tie_at`` counts bf16 rows).  Where "model" splits the linears, their row pieces' bf16
      outputs are summed (the tensor-parallel rounding, ``tp_main_path``'s),
      which these random weights amplify beyond that bound, so against
      long_decode's unplaced run the step is held to the whole-step rule:
      its RMS distance from the instance's f32 run within STEP_BF16_RATIO
      of the unplaced run's;
    - every position holds a quarter of each cache (SEQ_SPLIT_BYTES in
      bf16), each k/v leaf's positions over "data" (and its head_dim over
      "model" at (2, 2)); K2 a step at the rule table's count.

    Each run's step wall (host clock, synchronized) is recorded beside
    long_decode's.  The launches are read by the caller."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.models import api
    from repro_torch.models.sharded_cache import KVLayout, layout, place_slot_state, \
        state_position_bytes
    from repro_torch.tree import tree_map
    spec, prompt, steps = kept["spec"], kept["prompt"], kept["steps"]
    cuda = torch.device(device).type == "cuda"
    rms = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def decode(k, params, cache):
        """``steps`` serve steps of ``k``'s run (f32 greedy, bf16 fed):
        (logits [steps, V], ms a step)."""
        serve = api.build_serve_step(k["cfg"], spec)
        tok, logits = k["fed"][0].view(1, 1).to(torch.int32), []
        sync()
        t0 = time.time()
        with kernel_backend("cuda" if cuda else "reference"), torch.no_grad():
            for i in range(steps):
                if k["cfg"].dtype != torch.float32:
                    tok = k["fed"][i].view(1, 1).to(torch.int32)
                tok, lg, cache = serve(params, cache, tok,
                                       torch.full((1,), prompt + i, dtype=torch.long,
                                                  device=device))
                logits.append(lg[:, -1].float())
        sync()
        return torch.cat(logits), (time.time() - t0) / steps * 1e3

    def diff(got, want):
        """How far ``got``'s logits are from ``want``'s, and each step whose
        greedy token parts: a near tie where ``want``'s gap between the two
        tokens is within NEAR_TIE_SIGMAS * sqrt(2) * sigma, sigma the RMS of
        that step's logit difference (``tie_at``'s bf16 criterion)."""
        a, b = got.argmax(-1), want.argmax(-1)
        sigma = (got - want).pow(2).mean(-1).sqrt()
        gap = want.gather(-1, b[:, None])[:, 0] - want.gather(-1, a[:, None])[:, 0]
        parted = [{"step": i, "gap": gap[i].item(), "sigma": sigma[i].item(),
                   "near_tie": bool(gap[i] <= NEAR_TIE_SIGMAS * math.sqrt(2) * sigma[i])}
                  for i in torch.nonzero(a != b)[:, 0].tolist()]
        return {"max_rel_logit_diff": ((got - want).abs().max() / want.abs().max()).item(),
                "rms_rel_diff": rms(got, want),
                "token_agreement": (a == b).float().mean().item(), "parted": parted}

    runs, t_start = {}, time.time()
    for shape in meshes:
        mesh = tp_mesh(shape, device)
        M = shape[1]
        for which in ("f32", "bf16"):
            k = kept[which]
            c = k["cfg"]
            reset_peak()
            sync()
            t0 = time.time()
            params = shard_params(k["params"], c, mesh)
            cache = place_slot_state(tree_map(torch.clone, k["cache"]), c, mesh)
            sync()
            t_place = time.time() - t0
            lays = {layout(e["k"]) for sec in ("blocks", "tail") for e in cache[sec]}
            check(lays == {KVLayout(shape[0], -1 if M > 1 else None, M, -3)},
                  ("seq_split_decode layout", shape, lays))
            pos_bytes = [state_position_bytes(cache, i) for i in range(mesh.size)]
            whole = kv_bytes(c, spec.seq_len, True, torch.empty((), dtype=c.dtype).element_size())
            check(pos_bytes == [whole // mesh.size] * mesh.size,
                  ("seq_split_decode bytes per position", shape, which, pos_bytes, whole))
            if cuda and which == "bf16":
                check(pos_bytes == [SEQ_SPLIT_BYTES] * mesh.size and M * shape[0] == 4,
                      ("seq_split_decode bf16 bytes", shape, pos_bytes))
                check(k2_per_step(params) == (5 * M + 2) * c.n_layers,
                      ("seq_split_decode K2 pieces", shape, k2_per_step(params)))
            logits, ms = decode(k, params, cache)
            del cache
            want = k["logits"][1:]
            check(bool(torch.isfinite(logits).all()) and logits.shape == want.shape,
                  ("seq_split_decode logits", shape, which, logits.shape))
            run = {"mesh": list(shape), "layout": [list(lay) for lay in lays],
                   "position_bytes": pos_bytes, **diff(logits, want), "place_s": t_place,
                   "decode_ms_per_step": ms,
                   "max_memory_allocated": card_memory()[1] if cuda else None}
            if which == "bf16":
                same = want
                if M > 1:         # the same placed params over the unplaced cache
                    same, run["unplaced_cache_ms_per_step"] = decode(
                        k, params, tree_map(torch.clone, k["cache"]))
                run["same_params_unplaced_cache"] = diff(logits, same)
                r32 = k["f32_logits"][1:]
                run["ratio"] = rms(logits, r32) / rms(want, r32)
            del params
            runs[f"{which}_{shape[0]}x{shape[1]}"] = run
    if cuda:
        torch.cuda.empty_cache()
    line = {"phase": "seq_split_decode", "model": kept["bf16"]["cfg"].name,
            "max_len": spec.seq_len, "prompt": prompt, "steps": steps,
            "f32_bound": LONG_DECODE_F32_TOL, "bf16_bound": LONG_DECODE_BF16_LAYOUT_TOL,
            "ratio_bound": STEP_BF16_RATIO,
            "unplaced_decode_ms_per_step": {w: kept[w]["decode_ms_per_step"]
                                            for w in ("f32", "bf16")},
            "runs": runs, "seconds": time.time() - t_start}
    emit(line)
    print("seq_split_decode: " + "; ".join(
        f"{n} ({r['layout'][0][0]} position pieces) max rel diff {r['max_rel_logit_diff']:.3e} "
        f"RMS {r['rms_rel_diff']:.3e} agreement {r['token_agreement']:.3f}"
        + (f" (same params, unplaced cache: RMS "
           f"{r['same_params_unplaced_cache']['rms_rel_diff']:.3e} agreement "
           f"{r['same_params_unplaced_cache']['token_agreement']:.3f}; ratio {r['ratio']:.4f})"
           if "ratio" in r else "")
        + f", {r['decode_ms_per_step']:.2f} ms/step, {r['position_bytes'][0]} B a position"
        for n, r in runs.items()), flush=True)
    for n, r in runs.items():
        if n.startswith("f32"):
            check(r["token_agreement"] == 1.0 and r["max_rel_logit_diff"] < LONG_DECODE_F32_TOL
                  and r["rms_rel_diff"] < LONG_DECODE_F32_TOL, ("seq_split_decode f32", n, r))
        else:
            same = r["same_params_unplaced_cache"]
            check(all(p["near_tie"] for p in same["parted"])
                  and same["rms_rel_diff"] < LONG_DECODE_BF16_LAYOUT_TOL
                  and r["ratio"] <= STEP_BF16_RATIO, ("seq_split_decode bf16", n, r))
    return line


# ---------------------------------------------------------------------------
# tensor-parallel serving on a mesh whose positions share one card
# ---------------------------------------------------------------------------

TP_SEED = 83                     # the TP phases' generator: earlier phases' draws stay
TP_KERNEL_SEED = 89              # K2 at the pieces' shapes: adding a case moves no weight
TP_MESH = (1, 4)                 # (data, model) of the main path's mesh
TP_ENGINE = dict(slots=16, max_len=256, buckets=(32, 64))
TP_ROWS = 16
TP_MAX_NEW = 16
TP_LAYERS = 4                    # depth of tp_f32_parity's and tp_moe's models
TP_POOL_ENGINE = dict(slots=2, max_len=256, buckets=(32, 64), kv_layout="contiguous")
TP_POOL_SIZES = {"big": 300, "small0": 20, "small1": 20}   # bytes charged per tenant
TP_POOL_BUDGET = 100             # per position: big shards at 75, beside a small
PIPE_TOL = 1e-5                  # pipeline_forward against the sequential forward
SHARDED_TRAIN_SEED = 97          # the sharded training runs' generator
# a sharded train step against the unsharded one on the card, at the CPU
# gate's schedule and tolerances (tests/test_torch_sharded_training.py):
# lr 3e-3 warmed up over 2 steps, taken at step 1 (lr 1.5e-3)
SHARDED_LR, SHARDED_WARMUP, SHARDED_STEP = 3e-3, 2, 1
SHARDED_ATOL = 2e-6              # every gathered param and state element
SHARDED_GRAD_FLOOR = 1e-6        # below it an AdamW element's direction is f32 noise
SHARDED_BF16_RTOL = 2e-2         # the full-width bf16 steps' losses
SHARDED_FULL = dict(batch=2, seq_len=1024, xent_chunk=256, steps=2)
DP_FULL_MESH = (2, 2)            # (d): the full-width steps' rows over "data"
TP_RWKV_ROWS = 8                 # the w8-absmax rwkv6-3b mesh engine's rows
ALLREDUCE_TOL = 1e-6             # compressed_allreduce on the card against the CPU


def tp_mesh(shape, device="cuda", axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes, device=device)


def k2_per_step(params):
    """K2 launches of one model call (decode step or prefill) of an int8
    instance, from its tree alone: each ``QTensor`` (each piece of a
    sharded one) once per layer of its stack; a stacked expert stack is
    one launch a piece per layer (K2 over experts)."""
    from repro_torch.core.compressed import QTensor, ShardedTensor
    from repro_torch.tree import flatten_with_path

    def pieces(w):
        if isinstance(w, ShardedTensor):
            return sum(pieces(p) for p in w.pieces)
        return int(isinstance(w, QTensor))

    n = 0
    for path, leaf in flatten_with_path(params):
        k = pieces(leaf)
        if not k:
            continue
        main = leaf
        while isinstance(main, ShardedTensor):
            main = main.pieces[0]
        matrix = 3 if "moe" in path and path[-1] in ("wi", "wg", "wo") else 2
        n += k * math.prod(main.q.shape[:main.q.dim() - matrix])
    return n


def k2_rule_count(params, cfg, mesh):
    """K2 launches of one model call of the int8 instance ``params`` placed
    on ``mesh``, from the reference's rule table: each ``QTensor`` in as
    many pieces as its codes' spec splits it (a row split the port drops
    for its groups, ``replicated_qtensor_leaves``, not counted), once per
    layer of its stack."""
    from repro_torch.core.compressed import QTensor
    from repro_torch.distributed import sharding as SH
    from repro_torch.tree import flatten_with_path
    fn = SH.param_spec_fn(cfg, mesh)
    kept_whole = {r["path"] for r in SH.replicated_qtensor_leaves(params, cfg, mesh)}
    n = 0
    for path, leaf in flatten_with_path(params):
        if not isinstance(leaf, QTensor):
            continue
        k = math.prod(SH.axis_size(mesh, ax) for ax in fn(path + (0,), tuple(leaf.q.shape))
                      if ax is not None)
        if ".".join(map(str, path)) in kept_whole:
            k //= SH.axis_size(mesh, "model")
        matrix = 3 if "moe" in path and path[-1] in ("wi", "wg", "wo") else 2
        n += k * math.prod(leaf.q.shape[:leaf.q.dim() - matrix])
    return n


def _tp_tokens(tok, prompts, bucket, device):
    """The prompts as the engine's rows (BOS, text, SEP), right-padded to
    ``bucket``: (tokens [n, bucket], lengths [n])."""
    ids = [(tok.encode(p, bos=True) + [tok.SEP])[-bucket:] for p in prompts]
    toks = torch.zeros((len(ids), bucket), dtype=torch.long, device=device)
    for i, r in enumerate(ids):
        toks[i, :len(r)] = torch.tensor(r, device=device)
    return toks, torch.tensor([len(r) for r in ids], device=device)


def _route_rows(a, b, n):
    """[n] bool: the rows whose expert set is the same in every MoE layer
    of two runs' routes (all True without an MoE)."""
    same = torch.ones(n, dtype=torch.bool)
    for x, y in zip(a, b):
        same &= ~(torch.sort(x, -1).values != torch.sort(y, -1).values).any(-1).cpu()
    return same


def _tp_step_check(flat, sharded, cfg, tok, prompts, mesh, device, label, max_len=256):
    """One decode step of every prompt's row after its prefill (the
    unsharded instance's, on the served backend; its greedy token fed), on
    copies of that one state: the sharded instance on the served backend
    over the copy placed on ``mesh`` as ``Engine(mesh=)`` places its slot
    state (``place_slot_state``: attention piece by piece), the unsharded
    one on it and on the reference backend in bf16, and the f32 plain path
    (every float param and the state cast, codes kept).  Over the rows that
    every run routes to the same experts (all rows without an MoE; at least
    half of them), the sharded step's RMS error against f32 must be within
    STEP_BF16_RATIO of the plain bf16 step's (whole_step's bf16 criterion).
    The collectives of one more sharded step, over an unsharded copy (q/k/v
    gathered to the first device to attend, the route before the slot
    state followed ``cache_shardings``), are recorded for comparison."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.models import api
    from repro_torch.models.sharded_cache import place_slot_state
    from repro_torch.tree import tree_map
    rms = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    backend = "cuda" if torch.device(device).type == "cuda" else "reference"
    toks, lens = _tp_tokens(tok, prompts, 64, device)
    n = len(prompts)
    with kernel_backend(backend), torch.no_grad():
        lg, cache = api.prefill(flat, cfg, {"tokens": toks}, max_len=max_len, lengths=lens,
                                compact_local=False, cap_tokens=toks.shape[1])
    nxt = lg[torch.arange(n, device=toks.device), lens - 1].argmax(-1)[:, None]
    del lg

    def step(params, c, be, dtype, placed=False):
        st = tree_map(lambda t: t.to(dtype, copy=True) if t.is_floating_point() else t.clone(),
                      cache)
        if placed:
            st = place_slot_state(st, c, mesh)
        with RouteProbe() as probe, kernel_backend(be), torch.no_grad():
            out, _ = api.decode_step(params, c, st, nxt, lens, max_len=max_len)
        return out[:, -1].float(), probe.routes

    from repro_torch.distributed import collectives
    BACKGROUND.fence("collectives")     # no background job moves the counts read below
    collectives.reset_result_bytes()
    step(sharded, cfg, backend, cfg.dtype)
    before = {"calls": {k: n for k, n in collectives.calls.items() if n},
              "bytes": {k: n for k, n in collectives.result_bytes.items() if n}}
    t16, rt = step(sharded, cfg, backend, cfg.dtype, placed=True)
    c16, rc = step(flat, cfg, backend, cfg.dtype)
    r16, rr = step(flat, cfg, "reference", cfg.dtype)
    p32 = _f32(flat)
    r32, r3 = step(p32, cfg.replace(param_dtype="float32"), "reference", torch.float32)
    del p32, cache
    check(bool(torch.isfinite(t16).all()) and t16.shape == (n, cfg.vocab_size),
          (label, "sharded step logits", t16.shape))
    keep = _route_rows(rt, rc, n) & _route_rows(rt, rr, n) & _route_rows(rt, r3, n)
    k = keep.to(t16.device)
    line = {"rows": n, "rows_same_routes": int(keep.sum()),
            "sharded_vs_f32": rms(t16[k], r32[k]), "unsharded_vs_f32": rms(c16[k], r32[k]),
            "plain_bf16_vs_f32": rms(r16[k], r32[k]), "sharded_vs_unsharded": rms(t16, c16),
            "greedy_agreement_sharded_vs_unsharded":
                (t16.argmax(-1) == c16.argmax(-1)).float().mean().item(),
            "bf16_ratio_bound": STEP_BF16_RATIO, "collectives_unsharded_cache": before}
    line["bf16_ratio"] = line["sharded_vs_f32"] / line["plain_bf16_vs_f32"]
    check(2 * line["rows_same_routes"] >= n, (label, "rows routed alike", line))
    check(line["sharded_vs_f32"] <= STEP_BF16_RATIO * line["plain_bf16_vs_f32"], (label, line))
    return line


def spec_state_bytes(eng):
    """[bytes] each position of a mesh engine should hold of its slot
    state: every leaf's ``spec_bytes`` under the reference's rule
    (``cache_shardings``), recurrent leaves and ``enc_len`` included."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import api
    from repro_torch.tree import flatten_with_path
    meta = api.init_cache(eng.cfg, eng.slots, eng.max_len, compact_local=False, device="meta")
    specs = dict(flatten_with_path(SH.cache_shardings(eng.cfg, meta, eng.mesh),
                                   is_leaf=lambda x: isinstance(x, SH.P)))
    return [sum(SH.spec_bytes(t.shape, t.element_size(), specs[p], eng.mesh)
                for p, t in flatten_with_path(meta)) for i in range(eng.mesh.size)]


def state_split(state):
    """How a mesh engine's slot state is cut: the first k/v leaf's
    (data pieces, model dim, model pieces) and the first rwkv ``S`` or
    mamba ``h`` leaf's (data pieces, model pieces)."""
    from repro_torch.core.compressed import ShardedTensor
    from repro_torch.models.sharded_cache import head_layout, layout
    from repro_torch.tree import flatten_with_path
    out = {}
    for path, t in flatten_with_path(state):
        name = path[-1]
        if name == "k" and "kv" not in out:
            out["kv"] = list(layout(t)) if isinstance(t, ShardedTensor) else [1, None, 1]
        if name in ("S", "h") and "recurrent" not in out:
            out["recurrent"] = list(head_layout(t))
    return out


def decode_collectives(eng, label):
    """One decode step of the mesh engine ``eng`` on its sharded slot state
    (its current tokens and positions): the collectives' calls and result
    bytes by kind.  Gate: the bytes ``roofline.collective_bytes`` counts
    over that state."""
    from repro_torch.core.compressed import kernel_backend
    from repro_torch.distributed import collectives
    from repro_torch.launch import roofline
    BACKGROUND.fence("collectives")     # no background job moves the counts read below
    collectives.reset_result_bytes()
    with kernel_backend(eng.backend), torch.no_grad():
        eng._decode(None, eng._dev(eng._cur_tok), eng._dev(eng._cur_pos))
    sync()
    got = {"calls": {k: n for k, n in collectives.calls.items() if n},
           "bytes": {k: n for k, n in collectives.result_bytes.items() if n}}
    want = roofline.collective_bytes(eng.params, eng.cfg, eng.slots, eng._slot_state)
    check(got["bytes"] == {k: v for k, v in want.items() if v},
          (label, "collective bytes against the roofline", got, want))
    return got


def tp_main_path(gen, int8, cfg, device="cuda"):
    """Tensor-parallel serving of full-width gemma2-2b's ``w8-absmax``
    instance: ``Engine(mesh=)`` over a TP_MESH mesh whose positions are all
    on ``device`` (the params placed by the reference's rule table, every
    linear cut into 4 column or row pieces), TP_ROWS rows of TP_MAX_NEW
    tokens, against the unsharded contiguous engine on the same instance.
    The launch counts are zeroed just before the sharded run and read just
    after.  Gates: K2 launched at the rule table's count (28 pieces a layer,
    7 unsharded) per decode step and prefill, on ``decode`` and ``mma``,
    never ``fma``, and nothing else; the first decode step within whole_step's
    bf16 criterion (``_tp_step_check``); rows that part from the unsharded
    run near ties (``tie_at``); each position's slot state the rule's
    share (``spec_state_bytes``: 1/4 of the K/V at (1, 4), where KV heads
    split); one decode step's collectives the roofline's count, and where
    KV heads split 3 all-gathers a layer fewer than over an unsharded
    cache (no q/k/v gather).  Prints each position's bytes and, on the
    card, the sharded and unsharded decode steps' profiles."""
    from repro_torch.core.compressed import ShardedTensor, param_bytes, position_bytes
    from repro_torch.distributed.sharding import replicated_qtensor_leaves
    from repro_torch.kernels import ops
    from repro_torch.models.sharded_cache import layout, state_position_bytes
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import slot_state_bytes
    on_card = torch.device(device).type == "cuda"
    mesh = tp_mesh(TP_MESH, device)
    M = mesh.shape["model"]
    prompts = [TEMPLATE + r for r in REVIEWS[:TP_ROWS]]
    flat = Engine(int8, cfg, device=device, kv_layout="contiguous", version="w8-absmax",
                  **TP_ENGINE)
    sync()
    t0 = time.time()
    want = flat.generate(prompts, max_new=TP_MAX_NEW, prefix=TEMPLATE, return_requests=True)
    sync()
    flat_s = time.time() - t0
    ops.reset_launch_counts()
    with QuantShapeProbe() as probe:
        tp = Engine(int8, cfg, mesh=mesh, version="w8-absmax", **TP_ENGINE)
        sync()
        t0 = time.time()
        got = tp.generate(prompts, max_new=TP_MAX_NEW, prefix=TEMPLATE, return_requests=True)
        sync()
        tp_s = time.time() - t0
    launches = dict(ops.launch_count)
    variants = {k: n for k, n in ops.variant_count.items() if n}
    st = tp.stats
    per_step, flat_step = k2_per_step(tp.params), k2_per_step(int8)
    kept_whole = replicated_qtensor_leaves(int8, cfg, mesh)
    check(flat_step == 7 * cfg.n_layers and per_step == k2_rule_count(int8, cfg, mesh),
          ("K2 launches a step by the rule table", per_step, flat_step))
    # at full width every linear splits into M pieces: 28 a layer at (1, 4)
    check(bool(kept_whole) or per_step == M * flat_step, ("K2 pieces", per_step, flat_step))
    if on_card:
        check(launches == {"quant_matmul": per_step * (st.decode_steps + st.prefills),
                           "paged_attention": 0, "block_sparse_matmul": 0, "flash_attention": 0},
              ("sharded run launches", launches, st.decode_steps, st.prefills))
        check(variants == {"quant_matmul.decode": per_step * st.decode_steps,
                           "quant_matmul.mma": per_step * st.prefills},
              ("sharded run designs", variants))
    check(all(r.done for r in got) and st.rows == TP_ROWS, ("sharded rows", st))
    t0 = time.time()
    step = _tp_step_check(int8, tp.params, cfg, tp.tok, prompts, mesh, device, "tp_main_path")
    step["seconds"] = time.time() - t0
    agree, rows_same = _agreement(want, got)
    parted, t0 = [], time.time()
    if rows_same < TP_ROWS:
        p32 = _f32(int8)
        for a, b in zip(got, want):
            if a.out_ids != b.out_ids:
                parted.append({"prompt": b.src, **tie_at(int8, cfg, tp.tok, b.src, a.out_ids,
                                                         b.out_ids, tp.buckets[-1], p32)})
        del p32
    pos_bytes = [position_bytes(tp.params, i) for i in range(mesh.size)]
    state_bytes = [state_position_bytes(tp._slot_state, i) for i in range(mesh.size)]
    state_whole = TP_ENGINE["slots"] * slot_state_bytes(cfg, TP_ENGINE["max_len"])
    check(state_bytes == spec_state_bytes(tp) and state_bytes == [state_whole // M] * mesh.size,
          ("slot state per position", state_bytes, state_whole))
    split = layout(tp._slot_state["blocks"][0]["k"])
    after = decode_collectives(tp, "tp_main_path")
    before = step["collectives_unsharded_cache"]
    if split[1] == -2:
        # 3 gathers a layer fewer (q, k, v), less one a layer whose attention
        # wo is kept whole (its heads gathered instead of summed)
        whole = sum(cfg.n_layers // len(tp.params["blocks"]) for b in tp.params["blocks"]
                    if not isinstance(b["attn"]["wo"], ShardedTensor))
        check(before["calls"]["all-gather"] - after["calls"]["all-gather"]
              == 3 * cfg.n_layers - whole
              and before["calls"]["all-reduce"] == after["calls"]["all-reduce"],
              ("no q/k/v gather", before, after, whole))
    line = {"phase": "tp_main_path", "model": cfg.name, "layers": cfg.n_layers,
            "mesh": dict(mesh.shape), "devices": [str(d) for d in mesh.devices.flat],
            "rows": TP_ROWS, "max_new": TP_MAX_NEW, "engine": {**TP_ENGINE, "kv_layout": "contiguous"},
            "k2_per_step": per_step, "k2_per_step_unsharded": flat_step,
            "qtensors_kept_whole": kept_whole, "decode_steps": st.decode_steps, "prefills": st.prefills,
            "launches": launches, "variants": variants,
            "position_bytes": pos_bytes, "param_bytes_unsharded": param_bytes(int8),
            "slot_state_position_bytes": state_bytes, "slot_state_bytes_unsharded": state_whole,
            "cache_split": {"data": split[0], "model_dim": split[1], "model": split[2]},
            "collectives_per_step": after, "collectives_per_step_unsharded_cache": before,
            "wall_s": tp_s, "wall_s_unsharded": flat_s, "first_step": step,
            "greedy_token_agreement": agree, "rows_identical": rows_same, "parted": parted,
            "near_tie_s": time.time() - t0}
    check(all(p["near_tie"] for p in parted), ("rows parted beyond a near tie", parted))
    if on_card:
        t0 = time.time()
        line["profile"] = profile_step(gen, tp.params, tp, name="tp_decode_profile")
        line["profile_unsharded"] = profile_step(gen, int8, flat,
                                                 name="tp_decode_profile_unsharded")
        line["profile_s"] = time.time() - t0
    emit(line)
    print(f"tp_main_path: mesh {dict(mesh.shape)}, K2 {per_step} launches a step "
          f"({flat_step} unsharded), position bytes {pos_bytes} of {param_bytes(int8)}, "
          f"slot state {state_bytes} of {state_whole}; collective calls a decode step "
          f"{after['calls']} ({before['calls']} over an unsharded cache); "
          f"first step RMS vs f32 {step['sharded_vs_f32']:.3e} (unsharded "
          f"{step['unsharded_vs_f32']:.3e}, plain {step['plain_bf16_vs_f32']:.3e}); "
          f"agreement {agree:.4f}, {rows_same}/{TP_ROWS} rows identical, "
          f"{len(parted)} parted at near ties", flush=True)
    if on_card:
        for k in ("profile", "profile_unsharded"):
            p = line[k]
            print(f"  {k}: {p['wall_ms_per_step']:.3f} ms wall, {p['device_busy_ms_per_step']:.3f} "
                  f"ms device busy a decode step", flush=True)
    del tp, flat
    return line, launches, variants, probe.shapes


def check_quant_matmul_tp(shapes, name="tp_kernel_shapes"):
    """K2 against its plain version at every piece shape a sharded path
    launched (``_hold_seen``, fresh codes from a generator of its own, on
    the design each launch ran), then each piece's (K, N) timed at M = 8
    and at the path's most frequent prefill M: K2, its plain version,
    ``torch.matmul`` on the dequantized weight, and the bound.  The path
    ran ``decode`` and ``mma``, never ``fma``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TP_KERNEL_SEED)
    seen = {s[6] for s in shapes}
    check(seen == {"decode", "mma"}, ("K2 designs of the path", name, sorted(set(shapes))))
    results, worst_abs = _hold_seen(gen, shapes, {}, name)
    prefills = {s: n for s, n in shapes.items() if s[6] == "mma"}
    Mp = max(prefills, key=lambda s: (prefills[s], s[0]))[0]
    timed = {f"{K}x{N}_M{M}": _time_dense(gen, M, K, N)
             for K, N in sorted({(s[1], s[2]) for s in shapes}) for M in (8, Mp)}
    line = {"phase": name, "cases": results,
            "max_rel_err": max(r["rel_err"] for r in results), "max_abs_err": worst_abs,
            "tolerance": K2_TOL, "M_seen": sorted({s[0] for s in shapes}),
            "timed": timed, "library_note": "torch.matmul on the dequantized bf16 weight"}
    emit({**line, "cases": len(results)})
    print(f"K2 at {len(results)} shapes of {name}: max rel err {line['max_rel_err']:.3g}; "
          + "; ".join(f"{k} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, plain "
                      f"{t['plain_ms']:.4f}, matmul {t['library_ms']:.4f})"
                      for k, t in timed.items()), flush=True)
    return line


MULTI_POD_MESH = (2, 2, 1)              # ("pod", "data", "model")
MULTI_POD_ENGINE = dict(slots=8, max_len=256, buckets=(32, 64))
MULTI_POD_ROWS = 8


def multi_pod_engine(int8, cfg, device="cuda"):
    """Full-width gemma2-2b's ``w8-absmax`` instance behind ``Engine(mesh=)``
    over a MULTI_POD_MESH ("pod", "data", "model") mesh whose positions
    are all on ``device``: its 8 slots over "pod" and "data" (two a
    piece, pod-major), every slot-state leaf split with them, the params
    whole (a "model" axis of 1 splits nothing), MULTI_POD_ROWS rows of
    TP_MAX_NEW tokens with the template as a shared prefix, against the
    unsharded contiguous engine on the same instance.  The launch counts
    are zeroed just before the sharded run and read just after.  Gates:
    K2 launched at every piece's shape (the whole linears, 7 a layer, the
    rule table's count) per decode step and prefill, nothing else; rows
    that part from the unsharded run near ties (``tie_at``); each
    position's slot state the rule's share (a quarter); one decode step's
    collectives the roofline's count."""
    from repro_torch.kernels import ops
    from repro_torch.models.sharded_cache import KVLayout, data_split, layout, \
        state_position_bytes
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import slot_state_bytes
    on_card = torch.device(device).type == "cuda"
    mesh = tp_mesh(MULTI_POD_MESH, device, ("pod", "data", "model"))
    prompts = [TEMPLATE + r for r in REVIEWS[:MULTI_POD_ROWS]]
    flat = Engine(int8, cfg, device=device, kv_layout="contiguous", version="w8-absmax",
                  **MULTI_POD_ENGINE)
    want = flat.generate(prompts, max_new=TP_MAX_NEW, prefix=TEMPLATE, return_requests=True)
    ops.reset_launch_counts()
    eng = Engine(int8, cfg, mesh=mesh, version="w8-absmax", **MULTI_POD_ENGINE)
    sync()
    t0 = time.time()
    got = eng.generate(prompts, max_new=TP_MAX_NEW, prefix=TEMPLATE, return_requests=True)
    sync()
    wall = time.time() - t0
    launches = dict(ops.launch_count)
    st = eng.stats
    per_step = k2_per_step(eng.params)
    n_data = MULTI_POD_MESH[0] * MULTI_POD_MESH[1]
    lay = layout(eng._slot_state["blocks"][0]["k"])
    check(lay == KVLayout(n_data, None, 1, -4) and data_split(eng._slot_state) == n_data,
          ("multi_pod_engine k/v over pod x data", lay))
    check(per_step == k2_rule_count(int8, cfg, mesh) == 7 * cfg.n_layers,
          ("multi_pod_engine K2 a call", per_step))
    if on_card:
        check(launches == {"quant_matmul": per_step * (st.decode_steps + st.prefills),
                           "paged_attention": 0, "block_sparse_matmul": 0, "flash_attention": 0},
              ("multi_pod_engine launches", launches, st.decode_steps, st.prefills))
    check(all(r.done for r in got) and st.rows == MULTI_POD_ROWS, ("multi_pod_engine rows", st))
    state_bytes = [state_position_bytes(eng._slot_state, i) for i in range(mesh.size)]
    state_whole = MULTI_POD_ENGINE["slots"] * slot_state_bytes(cfg, MULTI_POD_ENGINE["max_len"])
    check(state_bytes == spec_state_bytes(eng) == [state_whole // n_data] * mesh.size,
          ("multi_pod_engine slot state per position", state_bytes, state_whole))
    coll = decode_collectives(eng, "multi_pod_engine")
    agree, rows_same = _agreement(want, got)
    parted = []
    if rows_same < MULTI_POD_ROWS:
        p32 = _f32(int8)
        parted = [{"prompt": b.src, **tie_at(int8, cfg, eng.tok, b.src, a.out_ids, b.out_ids,
                                             eng.buckets[-1], p32)}
                  for a, b in zip(got, want) if a.out_ids != b.out_ids]
        del p32
    line = {"phase": "multi_pod_engine", "model": cfg.name, "layers": cfg.n_layers,
            "mesh": dict(mesh.shape), "rows": MULTI_POD_ROWS, "max_new": TP_MAX_NEW,
            "engine": {**MULTI_POD_ENGINE, "kv_layout": "contiguous"},
            "k2_per_step": per_step, "decode_steps": st.decode_steps, "prefills": st.prefills,
            "prefix_hits": st.prefix_hits, "launches": launches,
            "slot_state_position_bytes": state_bytes, "slot_state_bytes_unsharded": state_whole,
            "collectives_per_step": coll, "wall_s": wall, "wall_s_unsharded": flat.stats.wall_s,
            "greedy_token_agreement": agree, "rows_identical": rows_same, "parted": parted}
    emit(line)
    print(f"multi_pod_engine: mesh {dict(mesh.shape)}, K2 {per_step} launches a call, slot "
          f"state {state_bytes} of {state_whole}; collective calls a decode step "
          f"{coll['calls']}; agreement {agree:.4f}, {rows_same}/{MULTI_POD_ROWS} rows "
          f"identical, {len(parted)} parted at near ties; {wall:.2f} s "
          f"({flat.stats.wall_s:.2f} unsharded)", flush=True)
    check(all(p["near_tie"] for p in parted), ("multi_pod_engine parted beyond a near tie",
                                               parted))
    return line, launches


def tp_rwkv(gen, base, cfg, device="cuda"):
    """rwkv6-3b's ``w8-absmax`` instance (published widths, its first
    ``SESSION_LAYERS`` layers, bf16) served by ``Engine(mesh=)`` at (1, 4)
    against the unsharded contiguous engine: TP_RWKV_ROWS rows of
    TP_MAX_NEW tokens.  ``S`` splits over its 40 heads (10 a position),
    ``wr``/``wk``/``wv``/``wg`` by columns in head order, so each position
    runs its heads' scan from its own pieces.  The counts are zeroed just
    before the sharded run and read just after.  Gates: K2 launched at the
    rule table's count per decode step and prefill, nothing else; the
    first decode step over the placed state within whole_step's bf16
    criterion (``_tp_step_check``); rows that part from the unsharded run
    near ties (``tie_at``); each position's slot state the spec's share
    (``spec_state_bytes``); one decode step's collectives the roofline's
    count.  Records both engines' decode-step profiles on the card."""
    from repro_torch.core.compressed import param_bytes, position_bytes
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.kernels import ops
    from repro_torch.models.sharded_cache import state_position_bytes
    from repro_torch.serving.engine import Engine
    on_card = torch.device(device).type == "cuda"
    cut, ccfg = cut_depth(base, cfg, SESSION_LAYERS[cfg.name])
    int8, ccfg, _ = InstanceOptimizer(cut, ccfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    mesh = tp_mesh(TP_MESH, device)
    prompts = [TEMPLATE + r for r in REVIEWS[:TP_RWKV_ROWS]]
    flat = Engine(int8, ccfg, device=device, kv_layout="contiguous", version="w8-absmax",
                  **TP_ENGINE)
    sync()
    t0 = time.time()
    want = flat.generate(prompts, max_new=TP_MAX_NEW, prefix=TEMPLATE, return_requests=True)
    sync()
    flat_s = time.time() - t0
    ops.reset_launch_counts()
    with QuantShapeProbe() as probe:
        tp = Engine(int8, ccfg, mesh=mesh, version="w8-absmax", **TP_ENGINE)
        sync()
        t0 = time.time()
        got = tp.generate(prompts, max_new=TP_MAX_NEW, prefix=TEMPLATE, return_requests=True)
        sync()
        tp_s = time.time() - t0
    launches = dict(ops.launch_count)
    variants = {k: n for k, n in ops.variant_count.items() if n}
    st = tp.stats
    per_step = k2_per_step(tp.params)
    check(per_step == k2_rule_count(int8, ccfg, mesh), ("rwkv K2 by the rule table", per_step))
    if on_card:
        check(launches == {"quant_matmul": per_step * (st.decode_steps + st.prefills),
                           "paged_attention": 0, "block_sparse_matmul": 0, "flash_attention": 0},
              ("rwkv sharded run launches", launches, st.decode_steps, st.prefills))
    check(all(r.done for r in got) and st.rows == TP_RWKV_ROWS, ("rwkv sharded rows", st))
    split = state_split(tp._slot_state)
    check(split["recurrent"] == [1, mesh.shape["model"]], ("rwkv S over heads", split))
    state_bytes = [state_position_bytes(tp._slot_state, i) for i in range(mesh.size)]
    check(state_bytes == spec_state_bytes(tp), ("rwkv slot state per position", state_bytes))
    t0 = time.time()
    step = _tp_step_check(int8, tp.params, ccfg, tp.tok, prompts, mesh, device, "tp_rwkv")
    step["seconds"] = time.time() - t0
    agree, rows_same = _agreement(want, got)
    parted = []
    if rows_same < TP_RWKV_ROWS:
        p32 = _f32(int8)
        for a, b in zip(got, want):
            if a.out_ids != b.out_ids:
                parted.append({"prompt": b.src, **tie_at(int8, ccfg, tp.tok, b.src, a.out_ids,
                                                         b.out_ids, tp.buckets[-1], p32)})
        del p32
    after = decode_collectives(tp, "tp_rwkv")
    line = {"phase": "tp_rwkv", "model": ccfg.name, "layers": ccfg.n_layers,
            "mesh": dict(mesh.shape), "rows": TP_RWKV_ROWS, "max_new": TP_MAX_NEW,
            "engine": {**TP_ENGINE, "kv_layout": "contiguous"}, "k2_per_step": per_step,
            "k2_per_step_unsharded": k2_per_step(int8), "decode_steps": st.decode_steps,
            "prefills": st.prefills, "launches": launches, "variants": variants,
            "position_bytes": [position_bytes(tp.params, i) for i in range(mesh.size)],
            "param_bytes_unsharded": param_bytes(int8), "slot_state_position_bytes": state_bytes,
            "state_split": split, "collectives_per_step": after, "wall_s": tp_s,
            "wall_s_unsharded": flat_s, "first_step": step, "greedy_token_agreement": agree,
            "rows_identical": rows_same, "parted": parted}
    check(all(p["near_tie"] for p in parted), ("rwkv rows parted beyond a near tie", parted))
    if on_card:
        line["profile"] = profile_step(gen, tp.params, tp, name="tp_rwkv_decode_profile")
        line["profile_unsharded"] = profile_step(gen, int8, flat,
                                                 name="tp_rwkv_decode_profile_unsharded")
    emit(line)
    print(f"tp_rwkv: mesh {dict(mesh.shape)}, K2 {per_step} launches a step "
          f"({line['k2_per_step_unsharded']} unsharded), slot state {state_bytes}; collective "
          f"calls a decode step {after['calls']}; first step RMS vs f32 "
          f"{step['sharded_vs_f32']:.3e} (unsharded {step['unsharded_vs_f32']:.3e}, plain "
          f"{step['plain_bf16_vs_f32']:.3e}, ratio {step['bf16_ratio']:.4f}); agreement "
          f"{agree:.4f}, {rows_same}/{TP_RWKV_ROWS} rows identical, {len(parted)} parted at "
          f"near ties", flush=True)
    if on_card:
        for k in ("profile", "profile_unsharded"):
            p = line[k]
            print(f"  {k}: {p['wall_ms_per_step']:.3f} ms wall, {p['device_busy_ms_per_step']:.3f} "
                  f"ms device busy a decode step", flush=True)
    del tp, flat
    return line, launches, probe.shapes


# the two placements beyond (1, 4) and (2, 2), for gemma2-2b: 3 slots at (2, 2),
# which "data" does not divide (the k/v positions over "data": the sequence
# split), and 8 slots over "pod" and "data" of a (2, 2, 1) multi-pod mesh
TP_F32_PLACEMENTS = {"gemma2-2b": (("2x2_slots3", (2, 2), ("data", "model"), 3, -3),
                                   ("2x2x1_pod", (2, 2, 1), ("pod", "data", "model"), 8, -4))}


def tp_f32_parity(cases, device="cuda", n_rows: int = 8, max_new: int = 8):
    """Each (name, params, cfg) case in f32 (raw weights: no kernel) served
    through the unsharded contiguous engine and through ``Engine(mesh=)``
    at (1, 4) and (2, 2), and at the placements of TP_F32_PLACEMENTS
    (against an unsharded engine of the same slot count): greedy tokens
    identical, or parted at a near tie of the f32 plain path (top-two gap
    under NEAR_TIE); each position's slot state the rule's share
    (``spec_state_bytes``) and one decode step's collectives the
    roofline's count (``decode_collectives``)."""
    from repro_torch.models.sharded_cache import layout, state_position_bytes
    from repro_torch.serving.engine import Engine
    prompts = [TEMPLATE + r for r in REVIEWS[:n_rows]]
    out = {}
    for name, params, cfg in cases:
        check(cfg.dtype == torch.float32, (name, "is not f32"))
        flat = Engine(params, cfg, device=device, kv_layout="contiguous", **TP_ENGINE)
        wants = {TP_ENGINE["slots"]: flat.generate(prompts, max_new=max_new,
                                                   return_requests=True)}
        res = {}
        placements = [("x".join(map(str, shape)), shape, ("data", "model"), TP_ENGINE["slots"],
                       None) for shape in ((1, 4), (2, 2))] + list(TP_F32_PLACEMENTS.get(name, ()))
        for label, shape, axes, slots, data_dim in placements:
            kw = {**TP_ENGINE, "slots": slots}
            if slots not in wants:
                wants[slots] = Engine(params, cfg, device=device, kv_layout="contiguous",
                                      **kw).generate(prompts, max_new=max_new,
                                                     return_requests=True)
            want = wants[slots]
            eng = Engine(params, cfg, mesh=tp_mesh(shape, device, axes), **kw)
            if data_dim is not None:
                kv = eng._slot_state["blocks"][0]["k"]
                check(layout(kv).data_dim == data_dim, (name, label, "k/v split", layout(kv)))
            got = eng.generate(prompts, max_new=max_new, return_requests=True)
            parted = [{"prompt": b.src, **tie_at(params, cfg, flat.tok, b.src, a.out_ids,
                                                 b.out_ids, flat.buckets[-1])}
                      for a, b in zip(got, want) if a.out_ids != b.out_ids]
            state_bytes = [state_position_bytes(eng._slot_state, i)
                           for i in range(eng.mesh.size)]
            check(state_bytes == spec_state_bytes(eng),
                  (name, label, "slot state per position", state_bytes))
            res[label] = {"rows_identical": n_rows - len(parted), "parted": parted,
                          "slots": slots, "axes": list(axes),
                          "slot_state_position_bytes": state_bytes,
                          "cache_split": state_split(eng._slot_state),
                          "collectives_per_step": decode_collectives(
                              eng, f"tp_f32_parity {name} {label}")}
            check(all(p["near_tie"] for p in parted), (name, label, "parted beyond a near tie",
                                                       parted))
            del eng
        out[name] = {"layers": cfg.n_layers, **res}
    line = {"phase": "tp_f32_parity", "rows": n_rows, "max_new": max_new, "models": out}
    emit(line)
    print("tp_f32_parity: " + "; ".join(
        f"{n}: " + ", ".join(f"{s} {r['rows_identical']}/{n_rows} identical"
                             for s, r in m.items() if s != "layers") for n, m in out.items()),
          flush=True)
    return line


def tp_moe(base, cfg, device="cuda", shape=(2, 2)):
    """qwen2-moe-a2.7b cut to TP_LAYERS layers, ``w8-absmax``, served
    through ``Engine(mesh=)`` at (2, 2): every expert stack split over
    "data" (its experts) and, where the groups allow, over "model", K2 over
    experts launched on every piece.  The counts are zeroed just before
    the sharded run and read just after.  Gates: K2 at the rule table's
    count per model call, nothing else; the first decode step within
    whole_step's bf16 criterion against the unsharded instance."""
    from repro_torch.core.compressed import ShardedTensor, position_bytes
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.distributed.sharding import replicated_qtensor_leaves
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    on_card = torch.device(device).type == "cuda"
    cut, ccfg = cut_depth(base, cfg, TP_LAYERS)
    int8, qcfg, _ = InstanceOptimizer(cut, ccfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    mesh = tp_mesh(shape, device)
    prompts = [TEMPLATE + r for r in REVIEWS[:TP_ROWS]]
    flat = Engine(int8, qcfg, device=device, kv_layout="contiguous", **TP_ENGINE)
    want = flat.generate(prompts, max_new=8, prefix=TEMPLATE, return_requests=True)
    ops.reset_launch_counts()
    tp = Engine(int8, qcfg, mesh=mesh, **TP_ENGINE)
    got = tp.generate(prompts, max_new=8, prefix=TEMPLATE, return_requests=True)
    launches = dict(ops.launch_count)
    variants = {k: n for k, n in ops.variant_count.items() if n}
    st = tp.stats
    moe = tp.params["blocks"][0]["moe"]
    check(all(isinstance(moe[n], ShardedTensor) and moe[n].axis == "data" for n in ("wi", "wg", "wo")),
          ("expert stacks not split over data", {n: repr(moe[n]) for n in ("wi", "wg", "wo")}))
    per_step = k2_per_step(tp.params)
    check(per_step == k2_rule_count(int8, qcfg, mesh), ("MoE K2 pieces", per_step))
    if on_card:
        check(launches == {"quant_matmul": per_step * (st.decode_steps + st.prefills),
                           "paged_attention": 0, "block_sparse_matmul": 0, "flash_attention": 0},
              ("MoE sharded launches", launches, st.decode_steps, st.prefills))
        check(variants.get("quant_matmul.expert_decode", 0) > 0
              and not any(k.endswith("fma") for k in variants), ("MoE sharded designs", variants))
    step = _tp_step_check(int8, tp.params, qcfg, tp.tok, prompts, mesh, device, "tp_moe")
    agree, rows_same = _agreement(want, got)
    line = {"phase": "tp_moe", "model": cfg.name, "layers": TP_LAYERS, "mesh": dict(mesh.shape),
            "k2_per_step": per_step, "k2_per_step_unsharded": k2_per_step(int8),
            "launches": launches, "variants": variants, "first_step": step,
            "replicated_qtensors": replicated_qtensor_leaves(int8, qcfg, mesh),
            "position_bytes": [position_bytes(tp.params, i) for i in range(mesh.size)],
            "greedy_token_agreement": agree, "rows_identical": rows_same}
    emit(line)
    print(f"tp_moe: mesh {dict(mesh.shape)}, K2 {per_step} launches a call "
          f"({line['k2_per_step_unsharded']} unsharded), first step RMS vs f32 "
          f"{step['sharded_vs_f32']:.3e} (plain {step['plain_bf16_vs_f32']:.3e}); "
          f"agreement {agree:.4f}, {rows_same}/{TP_ROWS} rows identical", flush=True)
    return line, launches


class _SameParamsSession:
    """Every qsig resolves to the same params under its own version, so the
    pool builds a real engine per tenant without a search."""

    def __init__(self, params, cfg, tok):
        self.params, self.cfg, self.tok = params, cfg, tok

    def _optimize(self, qsig, probe):
        from types import SimpleNamespace
        return SimpleNamespace(params=self.params, cfg=self.cfg, version=qsig)


def tp_pool(base, cfg, device="cuda"):
    """``ModelPool(mesh=)`` over a TP_MESH mesh, every tenant the
    ``w8-absmax`` instance of ``base`` under its own version: the "big" tenant charged
    over one position's budget (TP_POOL_SIZES) is admitted as one sharded
    engine over every position, beside two small tenants placed on one
    position each, and a ``Scheduler`` serves the three.  The counts are
    zeroed just before the run and read just after.  Gates: one sharded
    admission at placement (0, 1, 2, 3), the smalls on one position each,
    and every tenant's rows identical to a private engine with the same
    placement run serially."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import ModelPool, Scheduler
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.training.data import ByteTokenizer
    params, cfg, _ = InstanceOptimizer(base, cfg).apply(
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"))
    tok = ByteTokenizer(max(cfg.vocab_size, 260))
    mesh = tp_mesh(TP_MESH, device)
    pool = ModelPool(_SameParamsSession(params, cfg, tok), TP_POOL_BUDGET,
                     engine_kw={**TP_POOL_ENGINE, "device": device}, mesh=mesh,
                     entry_bytes=lambda m: TP_POOL_SIZES[m.version])
    sched = Scheduler(pool, share=2)
    prompts = {v: [TEMPLATE + r for r in REVIEWS[2 * i:2 * i + 2]]
               for i, v in enumerate(TP_POOL_SIZES)}
    ops.reset_launch_counts()
    subs = [sched.submit(v, ps, qsig=v, max_new=TP_MAX_NEW) for v, ps in prompts.items()]
    sched.run()
    launches = dict(ops.launch_count)
    check(pool.stats.sharded_admissions == 1 and pool.placement_of("big") == (0, 1, 2, 3),
          ("sharded admission", pool.stats, pool.placement_of("big")))
    places = {v: pool.placement_of(v) for v in TP_POOL_SIZES}
    check(all(len(places[v]) == 1 for v in ("small0", "small1")), ("small placements", places))
    rows = {}
    for sub in subs:
        kw = dict(TP_POOL_ENGINE)
        if sub.qsig == "big":
            kw["mesh"] = tp_mesh(TP_MESH, device)
        else:
            kw["device"] = pool.devices[places[sub.qsig][0]]
        ref = Engine(params, cfg, tokenizer=tok, version=sub.qsig,
                     **kw).generate(prompts[sub.tenant], max_new=TP_MAX_NEW)
        rows[sub.qsig] = {"identical": sub.results() == ref}
        check(sub.results() == ref, ("tenant rows differ from the serial run", sub.qsig,
                                     sub.results(), ref))
    line = {"phase": "tp_pool", "model": cfg.name, "layers": cfg.n_layers,
            "mesh": dict(mesh.shape), "budget_per_position": TP_POOL_BUDGET,
            "sizes": TP_POOL_SIZES, "placements": places, "pool_stats": vars(pool.stats),
            "device_bytes": [pool.device_bytes(i) for i in range(mesh.size)],
            "held_bytes_sharded": [pool.held_bytes(i) for i in range(mesh.size)],
            "launches": launches, "tenants": rows}
    emit(line)
    print(f"tp_pool: sharded admissions {pool.stats.sharded_admissions}, placements {places}, "
          f"charged {line['device_bytes']} a position, the sharded engine holding "
          f"{line['held_bytes_sharded']}; every tenant identical to its serial run", flush=True)
    return line, launches


def _sharded_opt(kind):
    from repro_torch.training import optimizer as OPT
    return getattr(OPT, kind)(lr=SHARDED_LR, warmup=SHARDED_WARMUP, total_steps=5)


def sharded_step_check(label, params, cfg, shape, fsdp, kind, device="cuda", capture=False,
                       strict=True, count=False):
    """One ``make_train_step`` step of ``params`` (f32) placed by
    ``place(params, param_shardings(cfg, params, mesh, fsdp=fsdp))`` on a
    mesh of ``shape`` on ``device``, against the same step of the tree
    unsharded on ``device``, with the CPU gate's schedule: loss and grad
    norm within LOSS_RTOL; each position's param and state bytes the
    ``spec_bytes`` of ``param_shardings`` and ``opt_state_shardings``.
    ``strict``: the CPU gate's tolerances too, every gathered param and
    state element within SHARDED_ATOL (an AdamW param element whose
    gradient is below SHARDED_GRAD_FLOOR within a flipped direction, 2 lr,
    and fewer than one in a thousand of them beyond SHARDED_ATOL).  Not
    ``strict``: where the gradients' f32 noise at full width moves an
    update by more than that, ``train_parity``'s gates of a step on two
    devices: the params' RMS difference within UPDATE_RMS_RTOL of their
    RMS update and no element beyond a flip (2 lr), the state's RMS
    difference within UPDATE_RMS_RTOL of its RMS; the largest differences
    are recorded either way, and the sharded step is held apart from its
    gradients (``_same_grads``): the unsharded optimizer on the sharded
    step's own gradients, gathered, gives its params and state within
    SHARDED_ATOL.  ``capture`` returns the sharded step's gradients too (a
    ``grad_compressor`` hook that keeps them).  ``count``: the collectives
    the sharded step records (forward, backward and the gradients'
    reduction over "data"; AdamW's update runs none) equal
    ``roofline.train_collectives`` by kind, bytes and calls (gate)."""
    from repro_torch.core.compressed import ShardedTensor, position_bytes
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.dryrun import bytes_per_position
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import flatten_with_path, leaves, tree_map
    mesh = tp_mesh(shape, device)
    sh = SH.param_shardings(cfg, params, mesh, fsdp=fsdp)
    o = _sharded_opt(kind)
    batch = _batch(0, cfg, device, 2, 128)
    flat = tree_map(torch.clone, params)
    fstate = o.init(flat)
    kept, flat_kept = [], []

    def keep(into):                   # a grad_compressor hook that keeps the gradients
        return lambda g, r: (into.append(g) or g, r)

    sync()
    t0 = time.time()
    out = make_train_step(cfg, o, grad_compressor=None if strict else keep(flat_kept))(
        flat, fstate, batch, SHARDED_STEP)
    flat, fstate, fm = out[0], out[1], out[-1]
    sync()
    flat_s = time.time() - t0
    placed = SH.place(tree_map(torch.clone, params), sh)
    state = o.init(placed)
    osh = SH.opt_state_shardings(sh, mesh, kind)
    want_p = bytes_per_position(params, sh)
    want_s = bytes_per_position(o.init(tree_map(lambda t: t.to("meta"), params)), osh)
    pos = [(position_bytes(placed, i), position_bytes(state, i)) for i in range(mesh.size)]
    check(all(abs(a - want_p) <= 1e-9 * want_p and abs(b - want_s) <= 1e-9 * want_s
              for a, b in pos), (label, "bytes per position", pos, want_p, want_s))
    check([SH.spec_of(t) for t in leaves(state)]
          == [x.spec for x in leaves(osh, is_leaf=SH._is_sharding)],
          (label, "optimizer state placed as opt_state_shardings"))
    step = make_train_step(cfg, o, grad_compressor=keep(kept) if capture or not strict
                           else None)
    if count:
        BACKGROUND.fence("collectives")     # no background job moves the counts read below
        collectives.reset_result_bytes()
    sync()
    t0 = time.time()
    out = step(placed, state, batch, SHARDED_STEP)
    sync()
    sharded_s = time.time() - t0
    counted = step_collectives(out[0], cfg, batch, label) if count else None
    placed, state, m = out[0], out[1], out[-1]
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    floss, fgnorm = float(fm["loss"]), float(fm["grad_norm"])
    m_flat = dict(flatten_with_path(fstate["m"])) if kind == "adamw" else {}
    worst, worst_noise, undetermined, total = 0.0, 0.0, 0, 0
    sums = {"param_diff2": 0.0, "param_update2": 0.0, "state_diff2": 0.0, "state2": 0.0}
    worst_of = {"params": 0.0, "state": 0.0}
    leaf_errs = []
    before = dict(flatten_with_path(params))     # the params before the step (not written)
    for (path, a), b in zip(flatten_with_path([placed, state]), leaves([flat, fstate])):
        a = SH.gather(a) if isinstance(a, ShardedTensor) else a
        err = (a.float() - b.float()).abs()
        group = "params" if path[0] == 0 else "state"
        worst_of[group] = max(worst_of[group], err.max().item())
        leaf_errs.append((err.max().item(), ".".join(map(str, path))))
        if group == "params":
            sums["param_diff2"] += torch.sum(err.double() ** 2).item()
            sums["param_update2"] += torch.sum((b.double() - before[path[1:]].double()) ** 2
                                               ).item()
        else:
            sums["state_diff2"] += torch.sum(err.double() ** 2).item()
            sums["state2"] += torch.sum(b.double() ** 2).item()
        if path[0] == 0 and kind == "adamw":
            noise = m_flat[path[1:]].abs() < (1 - 0.9) * SHARDED_GRAD_FLOOR
            worst = max(worst, err[~noise].max().item() if (~noise).any() else 0.0)
            if noise.any():
                worst_noise = max(worst_noise, err[noise].max().item())
            undetermined += int((noise & (err > SHARDED_ATOL)).sum())
            total += a.numel()
        else:
            worst = max(worst, err.max().item())
        del a, err
    lr_t = SHARDED_LR * SHARDED_STEP / SHARDED_WARMUP
    rms_rel = {"params": math.sqrt(sums["param_diff2"] / max(sums["param_update2"], 1e-300)),
               "state": math.sqrt(sums["state_diff2"] / max(sums["state2"], 1e-300))}
    line = {"model": cfg.name, "layers": cfg.n_layers, "mesh": list(shape), "fsdp": fsdp,
            "optimizer": kind, "dtype": "float32", "batch": [2, 128],
            "sharded_leaves": sum(isinstance(t, ShardedTensor) for t in leaves(placed)),
            "loss": loss, "loss_unsharded": floss, "grad_norm": gnorm,
            "grad_norm_unsharded": fgnorm, "max_abs_err": worst,
            "max_abs_err_undetermined": worst_noise, "undetermined_elements": undetermined,
            "param_elements": total, "tolerance": SHARDED_ATOL, "strict": strict,
            "max_abs_err_params": worst_of["params"], "max_abs_err_state": worst_of["state"],
            "rms_rel_err": rms_rel, "rms_rel_tolerance": UPDATE_RMS_RTOL,
            "worst_leaves": sorted(leaf_errs, reverse=True)[:4],
            "position_bytes": [a for a, _ in pos], "state_position_bytes": [b for _, b in pos],
            "seconds": sharded_s, "seconds_unsharded": flat_s,
            **({"collectives": counted} if counted is not None else {})}
    check(abs(loss / floss - 1) <= LOSS_RTOL and abs(gnorm / fgnorm - 1) <= LOSS_RTOL,
          (label, "loss and grad norm", line))
    if strict:
        check(worst <= SHARDED_ATOL and worst_noise <= 2 * lr_t * (1 + 1e-3)
              and undetermined * 1000 <= max(total, 1), (label, "params and state", line))
    else:
        check(rms_rel["params"] <= UPDATE_RMS_RTOL and rms_rel["state"] <= UPDATE_RMS_RTOL
              and worst_of["params"] <= 2 * lr_t * (1 + 1e-3),
              (label, "params and state (train_parity's gates)", line))
        worst_param = max(e for e in leaf_errs if e[1].startswith("0."))[1][2:]
        line["same_grads"] = _same_grads(label, params, o, kept[0], flat_kept[0], placed,
                                         state, flat, worst_param)
    del flat, fstate, state, flat_kept
    return line, placed, (kept[0] if capture else None), mesh


def step_collectives(placed, cfg, batch, label, xent_chunk=0, microbatches=1):
    """The collectives one ``make_train_step`` step of the placed tree
    recorded since the counts were zeroed (the caller fences the
    background's "collectives" jobs first): calls and result bytes by
    kind.  Gate: they equal ``roofline.train_collectives`` of the step
    (``microbatches``, remat on, ``xent_chunk``), and the batch was split
    over the dp axes."""
    from repro_torch.distributed import collectives
    from repro_torch.launch import roofline
    got = {"calls": {k: n for k, n in collectives.calls.items() if n},
           "bytes": {k: n for k, n in collectives.result_bytes.items() if n}}
    B, S = batch["tokens"].shape
    enc = batch["enc_inputs"].shape[1] if "enc_inputs" in batch else 0
    want = roofline.train_collectives(placed, cfg, roofline.TrainStep(
        B, S, microbatches, xent_chunk=xent_chunk, enc_len=enc))
    line = {"executed": got, "counted": {"calls": want["calls"], "bytes": want["bytes"]},
            "breakdown": want["breakdown"], "dp_split": want["split"],
            "split_by": want["split_by"], "per_device": want["per_device"]}
    check(want["split"] > 1 and got["bytes"] == {k: v for k, v in want["bytes"].items() if v}
          and got["calls"] == {k: v for k, v in want["calls"].items() if v},
          (label, "executed collectives equal roofline.train_collectives", line))
    return line


def _same_grads(label, params, o, grads, flat_grads, placed, state, flat, path):
    """The sharded step apart from its gradients: the unsharded optimizer
    ``o`` run on ``params`` with the sharded step's ``grads`` gathered gives
    the sharded step's ``placed`` params and ``state`` within SHARDED_ATOL
    (gate).  Records how those gradients differ from the unsharded step's
    ``flat_grads`` (largest, and RMS over that of the unsharded ones), and
    at leaf ``path`` (dotted, the params' worst against the unsharded step
    ``flat``) the element that parts most: its row's gradient difference
    over the row's gradient (RMS) and the row's mean square gradient over
    the mean of all its matrix's rows (Adafactor's ``vr``, which scales the
    row's update to its own size)."""
    from repro_torch.core.compressed import ShardedTensor
    from repro_torch.distributed import sharding as SH
    from repro_torch.tree import flatten_with_path, leaves, tree_map
    whole = lambda t: SH.gather(t) if isinstance(t, ShardedTensor) else t  # noqa: E731
    g_s = tree_map(whole, grads)
    x = tree_map(torch.clone, params)
    xs = o.init(x)
    x, xs = o.update(x, g_s, xs, SHARDED_STEP)
    err = max((whole(a).float() - b.float()).abs().max().item()
              for a, b in zip(leaves([placed, state]), leaves([x, xs])))
    del x, xs
    diff2 = ref2 = 0.0
    g_max = 0.0
    for a, b in zip(leaves(g_s), leaves(flat_grads)):
        d = (a.float() - b.float()).double()
        diff2 += torch.sum(d * d).item()
        ref2 += torch.sum(b.double() ** 2).item()
        g_max = max(g_max, d.abs().max().item())
    ps = dict(flatten_with_path(placed))
    key = next(k for k in ps if ".".join(map(str, k)) == path)
    a, b = whole(ps[key]).float(), dict(flatten_with_path(flat))[key].float()
    at = torch.unravel_index(torch.argmax((a - b).abs()), a.shape)
    row = tuple(int(i) for i in at[:-1])
    gs_l, gu_l = g_s, flat_grads
    for k in key:
        gs_l, gu_l = gs_l[k], gu_l[k]
    gu = gu_l.float()
    line = {"of": "the unsharded optimizer on the sharded step's gradients",
            "max_abs_err": err, "tolerance": SHARDED_ATOL,
            "grad_max_abs_diff": g_max, "grad_rms_rel_diff": math.sqrt(diff2 / ref2),
            "leaf": path, "element": [int(i) for i in at],
            "param_diff": (a - b)[at].item(),
            "leaf_grad_rms_rel_diff": ((gs_l.float() - gu).norm() / gu.norm()).item()}
    if a.dim() >= 2:
        rows2 = torch.mean(gu * gu, -1)           # each row's mean square gradient
        line["row_grad_rms_rel_diff"] = ((gs_l.float()[row] - gu[row]).norm()
                                         / gu[row].norm()).item()
        line["row_mean_square_over_mean"] = (rows2[row] / rows2.mean(-1)[row[:-1]]).item()
    check(err <= SHARDED_ATOL, (label, "optimizer on the same gradients", line))
    return line


def sharded_full_width(base, cfg, device="cuda"):
    """gemma2-2b at all its layers in bf16, AdamW: (c) placed at (1, 4),
    SHARDED_FULL's steps of ``make_train_step``; (d) placed at (2, 2)
    without FSDP (the reference's rule: 2.6 B params), the same steps
    data-parallel, each step's rows split over "data" (one row a
    position); then the same steps unsharded from the same params, run
    after the placed ones (not beside them).  Gates: each step's loss of
    (c) and of (d) within SHARDED_BF16_RTOL of the unsharded one's; each
    step of (d) records the collectives ``roofline.train_collectives``
    counts, by kind, bytes and calls (``step_collectives``); (c)'s params
    saved (``checkpoint.save`` writes each leaf gathered whole), restored
    unsharded and equal bit for bit (a ``BACKGROUND`` job tagged
    "collectives", its gathers being collectives, submitted after (d)'s
    counts are read; it restores onto the host).  Records each run's step
    wall, peak memory and FLOP share, and (d)'s bytes by kind."""
    import shutil
    import tempfile
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import leaves, tree_map
    kw = SHARDED_FULL
    mesh = tp_mesh((1, 4), device)
    flops = train_flops(cfg, kw["batch"], kw["seq_len"])
    runs = {}

    def run(params, label, count=False):
        o = make_optimizer("adamw", FULL_LR, kw["steps"])
        state = o.init(params)
        fn = make_train_step(cfg, o, xent_chunk=kw["xent_chunk"], remat=True)
        reset_peak()
        steps = []
        t_run = time.time()
        for i in range(kw["steps"]):
            b = _batch(i, cfg, device, kw["batch"], kw["seq_len"])
            if count:
                BACKGROUND.fence("collectives")     # no background job moves the counts
                collectives.reset_result_bytes()
            sync()
            t0 = time.time()
            params, state, m = fn(params, state, b, i)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            sync()
            dt = time.time() - t0
            check(math.isfinite(loss) and math.isfinite(gnorm), (label, i, loss, gnorm))
            steps.append({"step": i, "loss": loss, "grad_norm": gnorm, "seconds": dt,
                          "flop_share": flops / (dt * BF16_FLOPS)})
            if count:
                steps[-1]["collectives"] = step_collectives(params, cfg, b, (label, i),
                                                            kw["xent_chunk"])
        runs[label] = {"steps": steps, "peak_memory": card_memory()[1],
                       "steady_seconds": steps[-1]["seconds"],
                       "steady_flop_share": steps[-1]["flop_share"],
                       "seconds_all": time.time() - t_run}
        del state
        return params

    placed = run(SH.place(tree_map(torch.clone, base), SH.param_shardings(cfg, base, mesh)),
                 "sharded")
    mesh_dp = tp_mesh(DP_FULL_MESH, device)
    t0 = time.time()
    dp = run(SH.place(tree_map(torch.clone, base), SH.param_shardings(cfg, base, mesh_dp)),
             "data_parallel", count=True)
    del dp
    gc.collect()
    torch.cuda.empty_cache()
    runs["data_parallel"]["seconds_with_placement"] = time.time() - t0
    d = tempfile.mkdtemp(prefix="sharded_ckpt.", dir=os.path.join(ROOT, "build"))
    template = tree_map(lambda t: torch.empty(0), base)      # restore's structure only
    checkpoint = {}

    def round_trip(placed=placed):
        try:
            t0 = time.time()
            ckpt.save(d, kw["steps"], placed)
            # the bit-for-bit comparison below checks what restore's hash would
            restored, _, _ = ckpt.restore(d, template, device="cpu", verify=False)
            host = torch.device("cpu")
            same = all(_same_bits(SH.gather(a, host), b)
                       for a, b in zip(leaves(placed), leaves(restored)))
            checkpoint.update(same_bits=same, bytes=_dir_bytes(d), seconds=time.time() - t0,
                              restored_on="cpu")
        finally:
            shutil.rmtree(d, ignore_errors=True)
        check(same, ("sharded checkpoint restored unsharded", checkpoint))
        return {"phase": "parallel_training.checkpoint", **checkpoint}

    BACKGROUND.run(round_trip, tags=("collectives",))
    del placed, round_trip
    gc.collect()
    torch.cuda.empty_cache()
    flat = run(tree_map(torch.clone, base), "unsharded")
    del flat
    gc.collect()
    torch.cuda.empty_cache()
    rel = {k: [abs(a["loss"] / b["loss"] - 1)
               for a, b in zip(runs[k]["steps"], runs["unsharded"]["steps"])]
           for k in ("sharded", "data_parallel")}
    dp_bytes = [s["collectives"]["executed"]["bytes"] for s in runs["data_parallel"]["steps"]]
    line = {"model": cfg.name, "layers": cfg.n_layers, "dtype": "bfloat16", "mesh": [1, 4],
            "mesh_data_parallel": list(DP_FULL_MESH), "fsdp_data_parallel": False,
            "optimizer": "adamw", "lr": FULL_LR, **kw, "flops_per_step": flops, **runs,
            "loss_rel_err": rel["sharded"], "loss_rel_err_data_parallel": rel["data_parallel"],
            "data_parallel_bytes": dp_bytes, "tolerance": SHARDED_BF16_RTOL,
            "checkpoint": checkpoint}
    check(max(rel["sharded"]) <= SHARDED_BF16_RTOL, ("sharded bf16 steps' losses", line))
    check(max(rel["data_parallel"]) <= SHARDED_BF16_RTOL,
          ("data-parallel bf16 steps' losses", line))
    return line


def parallel_training(gen, base, cfg, device="cuda", layers: int = 4):
    """GPipe, the compressed all-reduce and sharded train steps on the card.
    ``pipeline_forward`` runs gemma2-2b's first ``layers`` blocks
    (published widths, f32) as 2 stages over a "stage" axis on 4
    microbatches, against the sequential forward (within PIPE_TOL,
    relative to the largest output).  Then a train step of a placed tree
    against the same step unsharded (``sharded_step_check``): (a) those
    ``layers`` layers in f32 at (2, 2) with FSDP, AdamW, its two rows split
    over "data" (one a position), its executed collectives equal to
    ``roofline.train_collectives``; (b) zamba2-7b at
    one group of its layout in f32 at (1, 4), Adafactor, held apart from its
    gradients too (``_same_grads``).  (a)'s sharded
    gradients, kept from its one backward, go through
    ``compressed_allreduce`` over the mesh's 2-position "data" axis,
    against the same function on the CPU (grads and residuals within
    ALLREDUCE_TOL; a ``BACKGROUND`` job on host copies, tagged
    "collectives", submitted after (d) so that it moves no count (d)
    reads).  (c) and (d) ``sharded_full_width``."""
    from repro_torch.configs import zamba2_7b
    from repro_torch.core.compressed import ShardedTensor
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import api
    from repro_torch.models.transformer import block_apply, layer_slice, pattern_unit
    from repro_torch.training.grad_compress import compressed_allreduce, init_residual
    from repro_torch.training.pipeline import pipeline_forward, split_stages
    from repro_torch.tree import flatten_with_path, leaves, tree_map
    t0 = time.time()
    cut, ccfg = cut_depth(base, cfg, layers)
    c32 = ccfg.replace(param_dtype="float32")
    unit, _, _ = pattern_unit(c32)
    stages = split_stages(_f32(cut["blocks"]), 2)
    mb, S = 2, 64
    pos = torch.arange(S, device=device).expand(mb, S)

    def stage_fn(p, x):
        for r in range(p[0]["ln1"]["w"].shape[0]):
            for u, kind in enumerate(unit):
                x = block_apply(layer_slice(p[u], r), x, c32, kind=kind, positions=pos)[0]
        return x

    x_mb = torch.randn((4, mb, S, cfg.d_model), generator=gen, device=device)
    with torch.no_grad():
        got = pipeline_forward(stage_fn, stages, x_mb, mesh=tp_mesh((2,), device, ("stage",)))
        want = []
        for m in range(x_mb.shape[0]):
            x = x_mb[m]
            for s in range(2):
                x = stage_fn(tree_map(lambda a, s=s: a[s], stages), x)
            want.append(x)
        want = torch.stack(want)
    pipe_err = errors(got, want)
    del stages
    pipe_s = time.time() - t0
    t0 = time.time()
    step_a, _, grads, mesh = sharded_step_check("sharded step (a)", _f32(cut), c32, (2, 2), True,
                                                "adamw", device, capture=True, count=True)
    step_a["seconds_all"] = time.time() - t0
    t0 = time.time()
    n_grad = sum(math.prod(g.shape) for g in leaves(grads))
    res = init_residual(grads)
    g_card, r_card = compressed_allreduce(grads, res, axis="data", mesh=mesh)

    def cpu(t):                       # a leaf whole on the host
        return SH.gather(t, torch.device("cpu")) if isinstance(t, ShardedTensor) \
            else t.detach().cpu()

    grads_h, res_h = tree_map(cpu, grads), tree_map(cpu, res)
    g_card, r_card = tree_map(cpu, g_card), tree_map(cpu, r_card)
    del grads, res
    gc.collect()
    torch.cuda.empty_cache()
    allreduce = {"of": "sharded step (a)'s gradients", "layers": layers, "axis": "data",
                 "positions": 2, "elements": n_grad, "tolerance": ALLREDUCE_TOL,
                 "seconds_card": time.time() - t0}

    def cpu_reference():
        # the same function on the host, off the card's critical path: its
        # collectives move the process-wide counts, so it carries their tag
        t0 = time.time()
        g_cpu, r_cpu = compressed_allreduce(grads_h, res_h, axis="data",
                                            mesh=tp_mesh((2,), "cpu", ("data",)))
        g_err = max((a.float() - b.float()).abs().max().item()
                    for (_, a), (_, b) in zip(flatten_with_path(g_card), flatten_with_path(g_cpu)))
        r_err = max((a - b).abs().max().item()
                    for (_, a), (_, b) in zip(flatten_with_path(r_card), flatten_with_path(r_cpu)))
        allreduce.update(grad_max_abs_err_vs_cpu=g_err, residual_max_abs_err_vs_cpu=r_err,
                         seconds_cpu=time.time() - t0)
        check(g_err <= ALLREDUCE_TOL and r_err <= ALLREDUCE_TOL,
              ("compressed_allreduce", allreduce))
        return {"phase": "parallel_training.compressed_allreduce", **allreduce}

    t0 = time.time()
    sgen = torch.Generator(device=device)
    sgen.manual_seed(SHARDED_TRAIN_SEED)
    zcfg = zamba2_7b.CONFIG.replace(n_layers=zamba2_7b.CONFIG.shared_attn_every + 1,
                                    param_dtype="float32")
    zparams = api.init_params(sgen, zcfg)
    step_b, _, _, _ = sharded_step_check("sharded step (b)", zparams, zcfg, (1, 4), False,
                                         "adafactor", device, strict=False)
    del zparams
    gc.collect()
    torch.cuda.empty_cache()
    step_b["seconds_all"] = time.time() - t0
    t0 = time.time()
    full = sharded_full_width(base, cfg, device)
    full["seconds_all"] = time.time() - t0
    # submitted after (d)'s counts are read: its collectives move the counts
    BACKGROUND.run(cpu_reference, tags=("collectives",))
    line = {"phase": "parallel_training", "pipeline": {
                "model": cfg.name, "layers": layers, "stages": 2, "microbatches": x_mb.shape[0],
                "microbatch": [mb, S, cfg.d_model], "dtype": "float32",
                "max_abs_err": pipe_err[0], "max_rel_err": pipe_err[1], "tolerance": PIPE_TOL,
                "seconds": pipe_s},
            "sharded_step_a": step_a, "sharded_step_b": step_b, "sharded_full_width": full,
            "compressed_allreduce": allreduce}
    emit(line)
    print(f"parallel_training: pipeline max rel err {pipe_err[1]:.3g} over {layers} layers in 2 "
          f"stages", flush=True)
    for k in ("sharded_step_a", "sharded_step_b"):
        r = line[k]
        print(f"  {k}: {r['model']} {r['layers']} layers at {r['mesh']} fsdp={r['fsdp']} "
              f"{r['optimizer']}: loss {r['loss']:.6f} ({r['loss_unsharded']:.6f} unsharded), "
              f"max abs err {r['max_abs_err']:.3g}, {r['undetermined_elements']} undetermined; "
              f"{r['seconds']:.2f} s a step ({r['seconds_unsharded']:.2f} unsharded)", flush=True)
        if "same_grads" in r:
            print(f"    {r['same_grads']}", flush=True)
    dpr = full["data_parallel"]
    print(f"  (d) data-parallel at {list(DP_FULL_MESH)}: losses "
          f"{[s['loss'] for s in dpr['steps']]}, step {dpr['steady_seconds']:.3f} s, peak "
          f"{dpr['peak_memory']}, {dpr['seconds_with_placement']:.1f} s with its placement; "
          f"bytes {full['data_parallel_bytes'][-1]} as counted", flush=True)
    print(f"  (a) collectives {step_a['collectives']['executed']} as counted", flush=True)
    print(f"  sharded_full_width: losses {[s['loss'] for s in full['sharded']['steps']]} vs "
          f"{[s['loss'] for s in full['unsharded']['steps']]}; step "
          f"{full['sharded']['steady_seconds']:.3f} s ({full['unsharded']['steady_seconds']:.3f} "
          f"unsharded), peak {full['sharded']['peak_memory']} "
          f"({full['unsharded']['peak_memory']})", flush=True)
    check(pipe_err[1] <= PIPE_TOL, ("pipeline_forward", line["pipeline"]))
    return line


SPLIT_FALLBACKS = {"positions": dict(batch=1, seq_len=2048, microbatches=1),
                   "microbatches": dict(batch=2, seq_len=1024, microbatches=2)}
# at most this share of a leaf's elements above SHARDED_GRAD_FLOOR may have
# gradients whose directions part between two bf16 computations of a step
# (a gradient gone wrong parts about half of its leaf's)
SPLIT_PARTED_SHARE = 0.25


def _bf16_step(p):
    """One bf16 step of each element of ``p`` (f32 of bf16 values): the
    spacing of bf16 numbers at its magnitude (8 significant bits)."""
    _, e = torch.frexp(p)
    return torch.ldexp(torch.ones_like(p), e - 8)


def _split_case(label, base, cfg, mesh, batch, M, xc, flops):
    """One AdamW step of ``base`` unsharded, then the same step of ``base``
    placed at ``mesh`` (no FSDP) split as ``data_parallel.plan_split``
    says, each step's gradients kept; the update element by element and
    the collectives against the count (the gates of phase 57).  Returns
    the case's line (``plan``: the split)."""
    from repro_torch.core.compressed import ShardedTensor
    from repro_torch.distributed import collectives
    from repro_torch.distributed import data_parallel as DP
    from repro_torch.distributed import sharding as SH
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import leaves, tree_map
    B, S = batch["tokens"].shape

    def run(params, count):
        o = make_optimizer("adamw", FULL_LR, 1)
        state = o.init(params)
        kept = []
        fn = make_train_step(cfg, o, microbatches=M, xent_chunk=xc, remat=True,
                             grad_compressor=lambda g, r: (kept.append(g) or g, r))
        if count:
            BACKGROUND.fence("collectives")     # no background job moves the counts
            collectives.reset_result_bytes()
        reset_peak()
        sync()
        t0 = time.time()
        params, state, _, m = fn(params, state, batch, 0)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        sync()
        dt = time.time() - t0
        check(math.isfinite(loss) and math.isfinite(gnorm), (label, loss, gnorm))
        del state
        return params, kept[0], {"loss": loss, "grad_norm": gnorm, "seconds": dt,
                                 "flop_share": flops / (dt * BF16_FLOPS),
                                 "peak_memory": card_memory()[1]}

    flat, g_flat, flat_run = run(tree_map(torch.clone, base), False)
    # held on the host beside the split step (its f32 gradients and
    # state need the card): the params, and the gradients in bf16
    flat = tree_map(lambda t: t.to("cpu"), flat)
    g_flat = tree_map(lambda t: t.to(torch.bfloat16).to("cpu"), g_flat)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    placed = SH.place(tree_map(torch.clone, base), SH.param_shardings(cfg, base, mesh))
    plan = DP.plan_split(mesh, B, S, M, cfg.family)
    placed, g_split, split_run = run(placed, True)
    split_run["seconds_with_placement"] = time.time() - t0
    counted = step_collectives(placed, cfg, batch, label, xc, M)
    lr = FULL_LR
    scale = {k: min(1.0, 1.0 / r["grad_norm"]) for k, r in (("split", split_run),
                                                            ("flat", flat_run))}
    worst = {"agree": 0.0, "part": 0.0, "leaf_part_share": 0.0, "grad_rms_rel": 0.0}
    differ = parted = flipped = above = total = 0
    for a, b, ga, gb in zip(leaves(placed), leaves(flat), leaves(g_split), leaves(g_flat)):
        whole = (lambda t: SH.gather(t) if isinstance(t, ShardedTensor) else t)
        a, ga = whole(a).float(), whole(ga).float() * scale["split"]
        b, gb = b.to(a.device).float(), gb.to(a.device).float() * scale["flat"]
        diff = (a - b).abs()
        step = _bf16_step(torch.maximum(a.abs(), b.abs()))
        near = (ga.abs() < SHARDED_GRAD_FLOOR) | (gb.abs() < SHARDED_GRAD_FLOOR)
        flip = ~near & (torch.sign(ga) != torch.sign(gb))
        part = near | flip
        if (~part).any():
            worst["agree"] = max(worst["agree"],
                                 ((diff - 0.02 * lr) / step)[~part].max().item())
        if part.any():
            worst["part"] = max(worst["part"], ((diff - 2.01 * lr) / step)[part].max().item())
        if (~near).any():
            worst["leaf_part_share"] = max(worst["leaf_part_share"],
                                           (flip.sum() / (~near).sum()).item())
        worst["grad_rms_rel"] = max(worst["grad_rms_rel"],
                                    ((ga - gb).norm() / gb.norm().clamp_min(1e-30)).item())
        differ += int((a != b).sum())
        parted += int(part.sum())
        flipped += int(flip.sum())
        above += int((~near).sum())
        total += a.numel()
        del a, b, ga, gb, diff, step, part, near, flip
    rel = abs(split_run["loss"] / flat_run["loss"] - 1)
    line = {"batch": [B, S], "microbatches": M, "split_by": plan.by,
            "blocks": plan.blocks, "dp_positions": plan.n, "split": split_run,
            "unsharded": flat_run, "loss_rel_err": rel,
            "agreeing_max_diff_beyond_lr_50th_in_bf16_steps": worst["agree"],
            "parted_max_diff_beyond_2lr_in_bf16_steps": worst["part"],
            "flipped_share_of_a_leaf_max": worst["leaf_part_share"],
            "grad_rms_rel_diff_of_a_leaf_max": worst["grad_rms_rel"],
            "elements_differing": differ, "elements_near_zero_or_flipped": parted,
            "elements_flipped": flipped, "elements_above_floor": above,
            "flipped_share_above_floor": flipped / max(above, 1),
            "param_elements": total, "collectives": counted, "plan": plan}
    del flat, placed, g_flat, g_split
    gc.collect()
    torch.cuda.empty_cache()
    check(rel <= SHARDED_BF16_RTOL, (label, "loss", line))
    check(worst["agree"] <= 1.0 and worst["part"] <= 1.0
          and worst["leaf_part_share"] <= SPLIT_PARTED_SHARE,
          (label, "update element by element", line))
    print(f"{label[0]} {label[1]}: {B} x {S} in {M} microbatch(es) split by "
          f"{plan.by} ({plan.blocks} blocks over {plan.n}): loss {split_run['loss']:.6f} "
          f"({flat_run['loss']:.6f} unsharded, rel {rel:.3g}); step "
          f"{split_run['seconds']:.3f} s ({flat_run['seconds']:.3f} unsharded), peak "
          f"{split_run['peak_memory']} ({flat_run['peak_memory']}); "
          f"{differ} of {total} elements differ; {parted} near-zero or flipped gradients, "
          f"{flipped} flipped of {above} above the floor; "
          f"collectives {counted['executed']['bytes']} in {counted['executed']['calls']} "
          f"calls as counted", flush=True)
    return line


def train_split_fallbacks(base, cfg, device="cuda"):
    """The train step's two split fallbacks at full width (phase 57): each
    case of SPLIT_FALLBACKS through :func:`_split_case` at DP_FULL_MESH.
    Returns the phase's line."""
    mesh = tp_mesh(DP_FULL_MESH, device)
    xc = SHARDED_FULL["xent_chunk"]
    line = {"phase": "train_split_fallbacks", "model": cfg.name, "layers": cfg.n_layers,
            "dtype": "bfloat16", "mesh": list(DP_FULL_MESH), "fsdp": False,
            "optimizer": "adamw", "lr": FULL_LR, "xent_chunk": xc, "remat": True,
            "tolerance": SHARDED_BF16_RTOL}
    for case, kw in SPLIT_FALLBACKS.items():
        B, S, M = kw["batch"], kw["seq_len"], kw["microbatches"]
        batch = _batch(0, cfg, device, B, S)
        r = _split_case(("train_split_fallbacks", case), base, cfg, mesh, batch, M, xc,
                        train_flops(cfg, B, S))
        plan = r.pop("plan")
        check(plan.by == ("positions" if case == "positions" else "rows"), (case, plan))
        line[case] = r
    emit(line)
    return line


# phase 58: one row of each model, its text positions over "data"
POSITION_SPLIT = (("paligemma-3b", 1024), ("whisper-base", 448))
POSITION_SPLIT_SEED = 59         # its generator: earlier phases' draws stay
SPLIT_FLIPPED_SHARE = 0.01       # of the gradient elements above SHARDED_GRAD_FLOOR


def train_position_split(device="cuda"):
    """The split of the positions over "data" for the vlm and encdec
    families at full width (phase 58): for each of POSITION_SPLIT, params
    and the row's image embeddings or frames from POSITION_SPLIT_SEED, one
    row of that many text tokens through :func:`_split_case` at
    DP_FULL_MESH (each "data" position its block of the text, the image or
    frames whole), gated as phase 57 and, over all of its elements, fewer
    than SPLIT_FLIPPED_SHARE of the gradients above the floor flipped.
    Returns the phase's line."""
    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import xent_chunk
    from repro_torch.models import api
    mesh = tp_mesh(DP_FULL_MESH, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(POSITION_SPLIT_SEED)
    line = {"phase": "train_position_split", "dtype": "bfloat16", "mesh": list(DP_FULL_MESH),
            "fsdp": False, "optimizer": "adamw", "lr": FULL_LR, "remat": True,
            "tolerance": SHARDED_BF16_RTOL, "flipped_share_limit": SPLIT_FLIPPED_SHARE}
    for name, S in POSITION_SPLIT:
        cfg = registry.get_config(name)
        base = api.init_params(gen, cfg)
        batch = {**_batch(0, cfg, device, 1, S), **family_extra(gen, cfg, 1, device)}
        xc = xent_chunk(cfg, S + (cfg.n_img_tokens if cfg.family == "vlm" else 0))
        r = _split_case(("train_position_split", name), base, cfg, mesh, batch, 1, xc,
                        train_flops(cfg, 1, S))
        plan = r.pop("plan")
        r.update(family=cfg.family, layers=cfg.n_layers, xent_chunk=xc, params=cfg.param_count())
        del base, batch
        gc.collect()
        torch.cuda.empty_cache()
        check(plan.by == "positions" and plan.blocks == DP_FULL_MESH[0], (name, plan))
        check(r["flipped_share_above_floor"] < SPLIT_FLIPPED_SHARE, (name, "flipped", r))
        line[name] = r
    emit(line)
    return line


def host_cpus() -> dict:
    """The host's CPUs as this process sees them: the count, the ones it
    may run on, what its cgroup's quota leaves (``usable_cpus``) and
    torch's intra-op threads."""
    return {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "usable": usable_cpus(), "torch_threads": torch.get_num_threads()}


TINY_PHASES = "--tiny-phases"    # chip_smoke.py --tiny-phases OUT: the tiny-olap phases alone


def tiny_phases(out_path: str) -> int:
    """``train_tiny_olap``, ``service_trained`` and ``examples``, in a
    process of their own that ``run`` starts (``python3 chip_smoke.py
    --tiny-phases OUT``) once the kernels are built: they need only
    ``tiny-olap`` and the K1/K2 libraries, and their host-bound work runs
    on a core of its own beside the main process's phases.  Each phase
    checks its gates here, so a failure exits non-zero; writes their lines,
    the service's and the examples' launches and their seconds to OUT."""
    import shutil
    from repro_torch.kernels import ops     # the libraries: built by the main process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    def timed(phase, fn, *a):
        t = time.time()
        out = fn(*a)
        seconds[phase] = time.time() - t
        print(f"phase {phase}: {seconds[phase]:.1f} s", flush=True)
        return out

    tiny_line, tiny_cfg, tiny_params = timed("train_tiny_olap", train_tiny_olap)
    ops.reset_launch_counts()
    svc_line = timed("service_trained", service_trained, tiny_params, tiny_cfg)
    svc_line["launches"] = dict(ops.launch_count)
    del tiny_params
    ex_line, ex_launches = timed("examples", examples_phase, TINY_CKPT)
    shutil.rmtree(TINY_CKPT, ignore_errors=True)
    with open(out_path, "w") as f:
        json.dump({"train_tiny_olap": tiny_line, "service_trained": svc_line,
                   "examples": ex_line, "examples_launches": ex_launches,
                   "seconds": seconds}, f)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == [TINY_PHASES]:
        return tiny_phases(sys.argv[2])
    from repro_torch.kernels import build
    BACKGROUND.start()
    try:
        return run()
    finally:
        build.stop_all()            # nvcc runs a failed run left
        for proc in CHILDREN:       # and the tiny-olap process
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        BACKGROUND.close()


CHILDREN = []                       # the processes run() starts


def run() -> int:
    t_start = time.time()
    from repro_torch.kernels import build, ops

    # one card: the run and its last line's "count" speak of one device
    check(torch.cuda.device_count() == 1,
          f"expected one visible card, found {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "host": host_cpus()})
    # the kernels compile while the training phases, which launch none of
    # them, run on the card; their CPU references wait for the build
    t0 = time.time()
    build.start_all()
    seconds = {}
    memory = {}                 # memory_allocated before and after each phase

    os.makedirs(OUT_DIR, exist_ok=True)

    def timed(phase, fn, *a, **kw):
        t, before = time.time(), card_memory()[0]
        out = fn(*a, **kw)
        seconds[phase] = time.time() - t
        memory[phase] = (before, card_memory()[0])
        print(f"phase {phase}: {seconds[phase]:.1f} s, memory_allocated "
              f"{before} -> {memory[phase][1]}", flush=True)
        # every phase's seconds so far: the record a run cut short leaves
        with open(os.path.join(OUT_DIR, "phase_seconds.json"), "w") as f:
            json.dump({"seconds": seconds, "since_start": time.time() - t_start}, f, indent=1)
        return out

    # every family trains: one f32 step at a cut depth on the card and the
    # CPU, then three bf16 steps at the published widths
    from repro_torch.configs import registry
    fgen = torch.Generator(device="cuda")
    fgen.manual_seed(TRAIN_FAMILY_SEED)
    family_parity = {}
    for arch, layers, opt, seq_len in TRAIN_FAMILY_PARITY:
        c = registry.get_config(arch).replace(n_layers=layers, param_dtype="float32")
        family_parity[arch] = timed(f"train_family_parity_{arch}", train_parity, fgen, c,
                                    opt=opt, seq_len=seq_len, name="train_family_parity")
        gc.collect()
        torch.cuda.empty_cache()
    family_full = {}
    for family, arch, kw in TRAIN_FULL_WIDTH:
        kw = dict(kw)
        c = registry.get_config(arch)
        c = c.replace(n_layers=kw.pop("layers", c.n_layers))
        family_full[family] = timed(f"train_full_width_{family}", train_full_width, c,
                                    name=f"train_full_width_{family}", **kw)
        gc.collect()
        torch.cuda.empty_cache()

    t1 = time.time()
    logs = build.build_all()
    build_wait = time.time() - t1
    BACKGROUND.open()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(build.KERNELS)) as pool:     # one cuobjdump each, together
        sass = dict(zip(build.KERNELS, pool.map(build.sass_counts, build.KERNELS)))
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
             for n, log in logs.items()}
    # the most bytes any kernel of each library spills to local memory
    spill = {n: max([int(m) for ln in lines
                     for m in re.findall(r"(\d+) bytes spill stores", ln)] or [0])
             for n, lines in ptxas.items()}
    emit({"phase": "build", "seconds": time.time() - t0, "wait_s": build_wait, "sass": sass,
          "spill_stores": spill})
    print("sass: " + ", ".join(f"{n} HGMMA {c['HGMMA']} HMMA {c['HMMA']} spill {spill[n]}"
                               for n, c in sass.items()), flush=True)
    for n in ("paged_attention", "quant_matmul", "flash_attention", "block_sparse"):
        check(sass[n]["HGMMA"] + sass[n]["HMMA"] > 0, (n, "has no tensor-core instruction"))
    for n in ("quant_matmul", "paged_attention"):
        check(spill[n] == 0, (n, "spills registers", ptxas[n]))

    # the build's wait, and its wall from the start of the nvcc runs
    seconds["build"], seconds["build_wall"] = build_wait, time.time() - t0

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k2, k2_cases = timed("kernel_quant_matmul", check_quant_matmul, gen)
    k1, k1_cases = timed("kernel_paged_attention", check_paged_attention, gen)
    k4, k4_cases = timed("kernel_block_sparse", check_block_sparse, gen)
    k3, k3_cases = timed("kernel_flash_attention", check_flash_attention, gen)
    main_line, launches, int8_variants, base, int8, eng8 = timed("main_path", main_path, gen)
    cfg = eng8.cfg
    step_line = timed("whole_step", whole_step, gen, int8, eng8,
                      {"quant_matmul": 7 * cfg.n_layers, "paged_attention": cfg.n_layers})
    prof_line = timed("decode_profile", profile_step, gen, int8, eng8)
    sa_line, sa_launches = timed("static_analysis", static_analysis, eng8, prof_line,
                                 kernels=("quant_matmul", "paged_attention"))
    del eng8
    torch.cuda.empty_cache()
    # tensor-parallel serving on a (1, 4) mesh whose positions are all this card
    tgen = torch.Generator(device="cuda")
    tgen.manual_seed(TP_SEED)
    tp_line, tp_launches, tp_variants, tp_shapes = timed("tp_main_path", tp_main_path, tgen,
                                                         int8, cfg)
    kq_tp = timed("tp_kernel_shapes", check_quant_matmul_tp, tp_shapes)
    # the same instance with its slots over "pod" and "data" of a (2, 2, 1) mesh
    mp_line, mp_launches = timed("multi_pod_engine", multi_pod_engine, int8, cfg)
    del int8
    # the tiny-olap phases in a second process, beside the phases below
    # (after the kernel timings of the phases above)
    tiny_out = os.path.join(OUT_DIR, "tiny_phases.json")
    tiny_log = os.path.join(OUT_DIR, "tiny_phases.log")
    with open(tiny_log, "w") as log:
        CHILDREN.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), TINY_PHASES, tiny_out],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT))
    t_tiny = time.time()
    torch.cuda.empty_cache()
    qe_line, qe_launches = timed("qembed_serve", qembed_serve, base, cfg)
    torch.cuda.empty_cache()
    bs_line, bs_launches, bs_variants, bsp, eng_bs = timed("block_sparse", block_sparse_path,
                                                           base, cfg)
    bs_step_line = timed("whole_step_block_sparse", whole_step, gen, bsp, eng_bs,
                         {"block_sparse_matmul": 7 * cfg.n_layers,
                          "paged_attention": cfg.n_layers}, name="whole_step_block_sparse")
    bs_prof_line = timed("decode_profile_block_sparse", profile_step, gen, bsp, eng_bs,
                         name="decode_profile_block_sparse")
    del bsp, eng_bs
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    long_line = timed("long_prefill", long_prefill, gen, base, cfg)
    long_launches = dict(ops.launch_count)
    long_variants = {k: n for k, n in ops.variant_count.items() if n}
    torch.cuda.empty_cache()
    olap_line, olap_launches, olap_variants = timed("olap_session", olap_session,
                                                    *cut_depth(base, cfg, SESSION_LAYERS[cfg.name]))
    torch.cuda.empty_cache()
    parity_line = timed("olap_f32_parity", olap_f32_parity, gen, cfg)
    pool_base, pool_cfg = cut_depth(base, cfg)
    fleet_line, fleet_launches = timed("olap_pool_fleet", olap_pool_fleet, pool_base, pool_cfg)
    pool_line, pool_launches = timed("olap_pool_session", olap_pool_session, pool_base,
                                     pool_cfg)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    svc_full_line = timed("service_full_width", service_full_width, pool_base, pool_cfg)
    service_runs = dict(ops.launch_count)
    svc_full_line["launches"] = dict(service_runs)
    torch.cuda.empty_cache()
    tp_pool_line, tp_pool_launches = timed("tp_pool", tp_pool, pool_base, pool_cfg)
    torch.cuda.empty_cache()
    par_line = timed("parallel_training", parallel_training, tgen, base, cfg)
    seconds["parallel_training.sharded_step_a"] = par_line["sharded_step_a"]["seconds_all"]
    seconds["parallel_training.data_parallel_full_width"] = (
        par_line["sharded_full_width"]["data_parallel"]["seconds_with_placement"])
    torch.cuda.empty_cache()
    split_line = timed("train_split_fallbacks", train_split_fallbacks, base, cfg)
    torch.cuda.empty_cache()
    position_line = timed("train_position_split", train_position_split)
    torch.cuda.empty_cache()
    # tp_f32_parity reads the collectives' counts: it runs after the MoE
    # session, so that the background's jobs tagged "collectives"
    # (parallel_training's) run beside the phases in between.  Its
    # gemma2-2b case waits on the host
    from repro_torch.tree import tree_map
    tp_g2, tp_g2_cfg = cut_depth(base, cfg, TP_LAYERS)
    tp_g2 = tree_map(lambda t: t.detach().to("cpu", copy=True), tp_g2)
    del base, pool_base
    torch.cuda.empty_cache()
    pool_parity_line, pool_parity_launches = timed("olap_pool_f32_parity",
                                                   olap_pool_f32_parity, gen, cfg)
    # the pooled runs of the three olap_pool phases (their serial references excluded)
    pool_runs = {k: fleet_launches.get(k, 0) + pool_launches.get(k, 0)
                 + pool_parity_launches.get(k, 0) for k in ops.launch_count}
    torch.cuda.empty_cache()
    train_parity_line = timed("train_parity", train_parity, gen,
                              cfg.replace(n_layers=4, attn_pattern="LG" * 2,
                                          param_dtype="float32"))
    torch.cuda.empty_cache()
    train_full_line = timed("train_full_width", train_full_width, cfg)
    torch.cuda.empty_cache()
    # the tiny-olap process: its gates ran there, its lines come back here
    t0 = time.time()
    rc = CHILDREN[0].wait()
    seconds["tiny_phases_wait"], seconds["tiny_phases_wall"] = time.time() - t0, time.time() - t_tiny
    with open(tiny_log) as f:
        tail = f.read()[-4000:]
    check(rc == 0, ("the tiny-olap phases failed", rc, tail))
    with open(tiny_out) as f:
        tiny = json.load(f)
    tiny_line, svc_line, ex_line = tiny["train_tiny_olap"], tiny["service_trained"], tiny["examples"]
    ex_launches = tiny["examples_launches"]
    for phase, t in tiny["seconds"].items():
        seconds[phase] = t
        print(f"phase {phase}: {t:.1f} s in the tiny-olap process", flush=True)
    for line in (tiny_line, svc_line, ex_line):
        emit(line)
    service_runs = {k: service_runs[k] + svc_line["launches"][k] for k in ops.launch_count}

    # the MoE phases: full-width qwen2-moe-a2.7b, from a generator of their own
    gc.collect()
    torch.cuda.empty_cache()
    print(f"MoE phases: memory_allocated {torch.cuda.memory_allocated()}", flush=True)
    mgen = torch.Generator(device="cuda")
    mgen.manual_seed(MOE_SEED)
    kx, kx_cases = timed("kernel_quant_matmul_experts", check_quant_matmul_experts)
    (moe_line, moe_launches, moe_variants_run, moe_base, moe_int8,
     moe_eng, moe_shapes) = timed("moe_main_path", moe_main_path, mgen)
    moe_cfg = moe_eng.cfg
    moe_step_line = timed("moe_whole_step", moe_whole_step, mgen, moe_int8, moe_eng)
    moe_prof_line = timed("moe_decode_profile", profile_step, mgen, moe_int8, moe_eng,
                          name="moe_decode_profile")
    del moe_int8, moe_eng
    gc.collect()
    torch.cuda.empty_cache()
    moe_sess_line, moe_sess_launches, moe_sess_shapes = timed(
        "moe_session", moe_session, *cut_depth(moe_base, moe_cfg, SESSION_LAYERS[moe_cfg.name]))
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs import granite_20b
    from repro_torch.models import api
    g4 = granite_20b.CONFIG.replace(n_layers=TP_LAYERS, param_dtype="float32")
    # rwkv6-3b (40 heads of 64: S over "model" at both meshes) and zamba2-7b
    # at one group of its layout (112 SSD heads: h over "model")
    from repro_torch.configs import rwkv6_3b, zamba2_7b
    r4 = rwkv6_3b.CONFIG.replace(n_layers=TP_LAYERS, param_dtype="float32")
    z1 = zamba2_7b.CONFIG.replace(n_layers=zamba2_7b.CONFIG.shared_attn_every + 1,
                                  param_dtype="float32")
    tp_cases = [("gemma2-2b", _f32(tree_map(lambda t: t.to("cuda"), tp_g2)),
                 tp_g2_cfg.replace(param_dtype="float32")),
                ("granite-20b", api.init_params(tgen, g4), g4),
                ("rwkv6-3b", api.init_params(tgen, r4), r4),
                ("zamba2-7b", api.init_params(tgen, z1), z1)]
    del tp_g2
    tp_parity_line = timed("tp_f32_parity", tp_f32_parity, tp_cases)
    del tp_cases
    gc.collect()
    torch.cuda.empty_cache()
    tp_moe_line, tp_moe_launches = timed("tp_moe", tp_moe, moe_base, moe_cfg)
    del moe_base
    gc.collect()
    torch.cuda.empty_cache()
    kx_seen = timed("kernel_quant_matmul_experts_seen", check_quant_matmul_experts_seen,
                    moe_shapes, moe_sess_shapes)
    kx["prefill"] = kx_seen["prefill"]
    moe_parity_line = timed("moe_f32_parity", olap_f32_parity, mgen, moe_cfg, 4,
                            name="moe_f32_parity")

    # the hybrid phases: full-width zamba2-7b, from generators of their own
    gc.collect()
    torch.cuda.empty_cache()
    print(f"hybrid phases: memory_allocated {torch.cuda.memory_allocated()}", flush=True)
    hgen = torch.Generator(device="cuda")
    hgen.manual_seed(HYBRID_SEED)
    k1h, k1h_cases = timed("kernel_paged_attention_d112", check_paged_attention_d112)
    k3h, k3h_cases = timed("kernel_flash_attention_d112", check_flash_attention_d112)
    with QuantShapeProbe() as hy_shapes:
        (hy_line, hy_launches, hy_variants, hy_base, hy_int8, hy_eng,
         hy_reqs) = timed("hybrid_main_path", hybrid_main_path, hgen)
    hy_cfg = hy_eng.cfg
    hy_step_line = timed("hybrid_whole_step", hybrid_whole_step, hgen, hy_int8, hy_eng)
    hy_contig_line = timed("hybrid_contiguous", hybrid_contiguous, hgen, hy_int8, hy_cfg,
                           hy_reqs)
    hy_prof_line = timed("hybrid_decode_profile", profile_step, hgen, hy_int8, hy_eng,
                         name="hybrid_decode_profile")
    in_proj = tuple(hy_int8["mamba_groups"]["in_proj"].q.shape[-2:])
    del hy_int8, hy_eng, hy_reqs
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    hy_long_line = timed("hybrid_long_prefill", hybrid_long_prefill, hgen, hy_base, hy_cfg)
    hy_long_launches = dict(ops.launch_count)
    gc.collect()
    torch.cuda.empty_cache()
    with QuantShapeProbe() as hy_sess_shapes:
        hy_sess_line, hy_sess_launches = timed(
            "hybrid_session", hybrid_session, *cut_depth(hy_base, hy_cfg,
                                                         SESSION_LAYERS[hy_cfg.name]))
    del hy_base
    gc.collect()
    torch.cuda.empty_cache()
    kq_seen = timed("kernel_quant_matmul_seen", check_quant_matmul_seen, hy_shapes.shapes,
                    hy_sess_shapes.shapes, *in_proj)
    hy_parity_line = timed("hybrid_f32_parity", olap_f32_parity, hgen, hy_cfg, 15,
                           name="hybrid_f32_parity")

    # the rwkv phases: full-width rwkv6-3b on the contiguous layout, from
    # generators of their own
    gc.collect()
    torch.cuda.empty_cache()
    print(f"rwkv phases: memory_allocated {torch.cuda.memory_allocated()}", flush=True)
    rgen = torch.Generator(device="cuda")
    rgen.manual_seed(RWKV_SEED)
    with QuantShapeProbe() as rw_shapes:
        rw_line, rw_launches, rw_base, rw_int8, rw_eng = timed("rwkv_main_path",
                                                                rwkv_main_path, rgen)
    rw_cfg = rw_eng.cfg
    rw_step_line = timed("rwkv_whole_step", rwkv_whole_step, rgen, rw_int8, rw_eng)
    rw_prof_line = timed("rwkv_decode_profile", profile_step, rgen, rw_int8, rw_eng,
                         name="rwkv_decode_profile")
    sa_rw_line, sa_rw_launches = timed("static_analysis_rwkv", static_analysis, rw_eng,
                                       rw_prof_line, name="static_analysis_rwkv")
    del rw_int8, rw_eng
    gc.collect()
    torch.cuda.empty_cache()
    with QuantShapeProbe() as rw_sess_shapes:
        rw_sess_line, rw_sess_launches = timed(
            "rwkv_session", rwkv_session, *cut_depth(rw_base, rw_cfg, SESSION_LAYERS[rw_cfg.name]))
    # the w8-absmax instance of the session's depth on a (1, 4) mesh: S over heads
    trgen = torch.Generator(device="cuda")
    trgen.manual_seed(TP_SEED)
    tp_rw_line, tp_rw_launches, tp_rw_shapes = timed("tp_rwkv", tp_rwkv, trgen, rw_base, rw_cfg)
    kq_tp_rw = timed("tp_rwkv_kernel_shapes", check_quant_matmul_tp, tp_rw_shapes,
                     "tp_rwkv_kernel_shapes")
    del rw_base
    gc.collect()
    torch.cuda.empty_cache()
    kq_rwkv = timed("kernel_quant_matmul_rwkv", check_quant_matmul_rwkv, rw_shapes.shapes,
                    rw_sess_shapes.shapes)
    rw_parity_line = timed("rwkv_f32_parity", olap_f32_parity, rgen, rw_cfg, 4,
                           name="rwkv_f32_parity")

    # the vlm phases: full-width paligemma-3b with image embeddings, from
    # generators of their own
    gc.collect()
    torch.cuda.empty_cache()
    print(f"vlm phases: memory_allocated {torch.cuda.memory_allocated()}", flush=True)
    vgen = torch.Generator(device="cuda")
    vgen.manual_seed(VLM_SEED)
    with QuantShapeProbe() as vl_shapes:
        vl_line, vl_launches, vl_base, vl_int8, vl_eng, _ = timed("vlm_main_path",
                                                                  vlm_main_path, vgen)
    vl_cfg = vl_eng.cfg
    vl_step_line = timed("vlm_whole_step", vlm_whole_step, vgen, vl_int8, vl_eng)
    vl_prof_line = timed("vlm_decode_profile", profile_step, vgen, vl_int8, vl_eng,
                         name="vlm_decode_profile")
    del vl_int8, vl_eng
    gc.collect()
    torch.cuda.empty_cache()
    with QuantShapeProbe() as vl_sess_shapes:
        vl_sess_line, vl_sess_launches = timed(
            "vlm_session", vlm_session, *cut_depth(vl_base, vl_cfg, SESSION_LAYERS[vl_cfg.name]))
    del vl_base
    gc.collect()
    torch.cuda.empty_cache()
    vl_parity_line = timed("vlm_f32_parity", vlm_f32_parity, vgen, vl_cfg)

    # the encdec phases: full-width whisper-base from encoder frames
    gc.collect()
    torch.cuda.empty_cache()
    egen = torch.Generator(device="cuda")
    egen.manual_seed(ENCDEC_SEED)
    with QuantShapeProbe() as ed_shapes:
        (ed_line, ed_launches, ed_base, ed_int8, ed_eng, ed_frames,
         ed_base_reqs) = timed("encdec_main_path", encdec_main_path, egen)
    ed_cfg = ed_eng.cfg
    ed_prof_line = timed("encdec_decode_profile", profile_step, egen, ed_int8, ed_eng,
                         name="encdec_decode_profile")
    del ed_int8, ed_eng
    with QuantShapeProbe() as ed_build_shapes:
        ed_build_line, ed_build_launches = timed("encdec_build", encdec_build, ed_base, ed_cfg,
                                                 ed_frames, ed_base_reqs)
    del ed_base, ed_frames
    gc.collect()
    torch.cuda.empty_cache()
    ed_parity_line = timed("encdec_f32_parity", encdec_f32_parity, egen, ed_cfg)
    kq_ve = timed("kernel_quant_matmul_vlm_encdec", check_quant_matmul_vlm_encdec,
                  vl_shapes.shapes, vl_sess_shapes.shapes, ed_shapes.shapes,
                  ed_build_shapes.shapes)

    # the granite phases: full-width granite-20b, 48 query heads on one KV
    # head (K1's `mma` design), from generators of their own
    gc.collect()
    torch.cuda.empty_cache()
    print(f"granite phases: memory_allocated {torch.cuda.memory_allocated()}", flush=True)
    ggen = torch.Generator(device="cuda")
    ggen.manual_seed(GRANITE_SEED)
    k1g, k1g_cases = timed("kernel_paged_attention_g48", check_paged_attention_g48)
    k3g, k3g_cases = timed("kernel_flash_attention_g48", check_flash_attention_g48)
    with QuantShapeProbe() as gr_shapes:
        gr_line, gr_launches, gr_base, gr_int8, gr_eng = timed("granite_main_path",
                                                                granite_main_path, ggen)
    gr_cfg = gr_eng.cfg
    gr_k2, gr_k1 = granite_per_call(gr_cfg)
    gr_step_line = timed("granite_whole_step", whole_step, ggen, gr_int8, gr_eng,
                         {"quant_matmul": gr_k2, "paged_attention": gr_k1}, trials=3,
                         name="granite_whole_step")
    gr_prof_line = timed("granite_decode_profile", profile_step, ggen, gr_int8, gr_eng,
                         name="granite_decode_profile")
    gr_prof_line["byte_floor_ms_int8"] = gr_line["byte_floor_ms_int8"]
    print(f"granite decode step: {gr_prof_line['wall_ms_per_step']:.3f} ms wall, "
          f"{gr_prof_line['device_busy_ms_per_step']:.3f} ms device busy, idle share "
          f"{gr_prof_line['device_idle_share']:.3f}, byte floor "
          f"{gr_line['byte_floor_ms_int8']:.3f} ms", flush=True)
    del gr_int8, gr_eng
    gc.collect()
    torch.cuda.empty_cache()
    gr_cut, gr_cut_cfg = cut_depth(gr_base, gr_cfg, GRANITE_SESSION_LAYERS)
    gr_cut = _tree_copy(gr_cut)
    del gr_base
    gc.collect()
    torch.cuda.empty_cache()
    with QuantShapeProbe() as gr_sess_shapes:
        gr_sess_line, gr_sess_launches = timed("granite_session", granite_session, gr_cut,
                                               gr_cut_cfg)
    del gr_cut
    gc.collect()
    torch.cuda.empty_cache()
    kq_gr = timed("kernel_quant_matmul_granite", check_quant_matmul_granite, gr_shapes.shapes,
                  gr_sess_shapes.shapes)
    gr_parity_line = timed("granite_f32_parity", olap_f32_parity, ggen, gr_cfg, 4,
                           name="granite_f32_parity")

    # full-width gemma3-1b at long_500k over the compact local-window cache
    gc.collect()
    torch.cuda.empty_cache()
    print(f"long_decode: memory_allocated {torch.cuda.memory_allocated()}", flush=True)
    ops.reset_launch_counts()
    ld_line, ld_kept = timed("long_decode", long_decode, keep=True)
    ld_launches = dict(ops.launch_count)
    ld_line["launches"] = ld_launches
    ld_line["variants"] = {k: n for k, n in ops.variant_count.items() if n}
    ld_want = long_decode_launches()
    print(f"long_decode launches: {ld_launches} (designs {ld_line['variants']}), "
          f"{seconds['long_decode']:.1f} s", flush=True)
    check(ld_launches == ld_want, ("long_decode launches", ld_launches, ld_want))
    # the same compact caches split along their positions, at (2, 2) and (4, 1)
    ops.reset_launch_counts()
    ss_line = timed("seq_split_decode", seq_split_decode, ld_kept)
    ss_launches = dict(ops.launch_count)
    ss_line["launches"] = ss_launches
    ss_line["variants"] = {k: n for k, n in ops.variant_count.items() if n}
    del ld_kept
    ss_want = seq_split_decode_launches()
    print(f"seq_split_decode launches: {ss_launches} (designs {ss_line['variants']}), "
          f"{seconds['seq_split_decode']:.1f} s", flush=True)
    check(ss_launches == ss_want, ("seq_split_decode launches", ss_launches, ss_want))

    # the background's CPU references: their lines, and any failure
    t0 = time.time()
    BACKGROUND.fence()
    seconds["background_wait_end"] = time.time() - t0
    seconds["background_wait"] = BACKGROUND.waited_s

    kernels = []
    for line, runs, variants, source, replaces in (
            (k1, launches, int8_variants, "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:68"),
            (k2, launches, int8_variants, "src/repro_torch/kernels/csrc/quant_matmul.cu",
             "src/repro/kernels/quant_matmul.py:47"),
            (k3, long_launches, long_variants, "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:83"),
            (k4, bs_launches, bs_variants, "src/repro_torch/kernels/csrc/block_sparse.cu",
             "src/repro/kernels/block_sparse.py:39")):
        check(runs[line["name"]] > 0, ("no launch on the path", line["name"], runs))
        by_path = {"olap_session": olap_launches[line["name"]],
                   "olap_pool": pool_runs[line["name"]],
                   "service": service_runs[line["name"]]}
        if line["name"] in ("paged_attention", "quant_matmul"):
            check(by_path["olap_session"] > 0, ("no launch in the OLAP session", line["name"]))
            check(by_path["olap_pool"] > 0, ("no launch in the pooled OLAP runs", line["name"]))
            check(by_path["service"] > 0, ("no launch in the service phases", line["name"]))
        else:
            check(by_path["olap_pool"] == 0, ("off the pooled path", line["name"]))
            check(by_path["service"] == 0, ("off the service path", line["name"]))
        kernels.append({"name": line["name"], "route": "cuda", "source": source,
                        "replaces": replaces, "launches": runs[line["name"]],
                        "launches_olap_session": by_path["olap_session"],
                        "launches_olap_pool": by_path["olap_pool"],
                        "launches_service": by_path["service"],
                        "max_abs_err": line["max_abs_err"], "ms": line["ms"],
                        "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
                        "bound_by": line["bound_by"], "library_ms": line["library_ms"],
                        "bound_share": line["bound_ms"] / line["ms"],
                        "check": "pass", "cases": line["cases"],
                        "max_rel_err": line["max_rel_err"],
                        "variants": {k.split(".")[1]: n for k, n in variants.items()
                                     if k.startswith(line["name"] + ".")}})
        # the MoE path (moe_main_path's int8 run): K1, K2 and K2 over experts
        moe_runs = moe_launches[line["name"]]
        kernels[-1]["launches_moe"] = moe_runs
        kernels[-1]["launches_moe_session"] = moe_sess_launches[line["name"]]
        if line["name"] in ("paged_attention", "quant_matmul"):
            check(moe_runs > 0 and moe_sess_launches[line["name"]] > 0,
                  ("no launch on the MoE path", line["name"]))
        else:
            check(moe_runs == 0, ("off the MoE path", line["name"]))
        # the hybrid path (hybrid_main_path's int8 run, the session, the long
        # prefill): K1 at every shared site, K2 on every linear, K3 in the prefill
        name = line["name"]
        kernels[-1]["launches_hybrid"] = hy_launches[name]
        kernels[-1]["launches_hybrid_session"] = hy_sess_launches[name]
        kernels[-1]["launches_hybrid_long_prefill"] = hy_long_launches[name]
        if name in ("paged_attention", "quant_matmul"):
            check(hy_launches[name] > 0 and hy_sess_launches[name] > 0
                  and hy_long_launches[name] == 0, ("the hybrid path", name))
        elif name == "flash_attention":
            check(hy_launches[name] == 0 and hy_long_launches[name] > 0,
                  ("the hybrid path", name))
        else:
            check(hy_launches[name] == hy_sess_launches[name] == hy_long_launches[name] == 0,
                  ("off the hybrid path", name))
        # the rwkv path (rwkv_main_path's int8 run, the session): K2 only
        kernels[-1]["launches_rwkv"] = rw_launches[name]
        kernels[-1]["launches_rwkv_session"] = rw_sess_launches[name]
        if name == "quant_matmul":
            check(rw_launches[name] > 0 and rw_sess_launches[name] > 0, ("the rwkv path", name))
        else:
            check(rw_launches[name] == rw_sess_launches[name] == 0, ("off the rwkv path", name))
        # the vlm and encdec paths (their main paths' int8 runs, the vlm
        # session): K2 only
        kernels[-1]["launches_vlm"] = vl_launches[name]
        kernels[-1]["launches_vlm_session"] = vl_sess_launches[name]
        kernels[-1]["launches_encdec"] = ed_launches[name]
        kernels[-1]["launches_encdec_build"] = ed_build_launches[name]
        if name == "quant_matmul":
            check(vl_launches[name] > 0 and vl_sess_launches[name] > 0 and ed_launches[name] > 0
                  and ed_build_launches[name] > 0, ("the vlm and encdec paths", name))
        else:
            check(vl_launches[name] == vl_sess_launches[name] == ed_launches[name]
                  == ed_build_launches[name] == 0, ("off the vlm and encdec paths", name))
        # the hot-path audits: gemma2-2b's paged int8 engine (K1 and K2) and
        # rwkv6-3b's contiguous one (K2)
        kernels[-1]["launches_static_analysis"] = sa_launches[name]
        kernels[-1]["launches_static_analysis_rwkv"] = sa_rw_launches[name]
        if name == "quant_matmul":
            check(sa_launches[name] > 0 and sa_rw_launches[name] > 0, ("the audits", name))
        elif name == "paged_attention":
            check(sa_launches[name] > 0 and sa_rw_launches[name] == 0, ("the audits", name))
        else:
            check(sa_launches[name] == sa_rw_launches[name] == 0, ("off the audits", name))
        # tensor-parallel serving (the sharded runs of tp_main_path, tp_pool
        # and tp_moe): K2 on every piece, nothing else
        # the five examples on the card: K1 on every serving example, K2 on
        # the int8 picks and multi_tenant's w8 pool
        kernels[-1]["launches_examples"] = ex_launches.get(name, 0)
        if name in ("paged_attention", "quant_matmul"):
            check(ex_launches.get(name, 0) > 0, ("the examples", name))
        kernels[-1]["launches_tp"] = tp_launches[name]
        kernels[-1]["launches_tp_pool"] = tp_pool_launches[name]
        kernels[-1]["launches_tp_moe"] = tp_moe_launches[name]
        kernels[-1]["launches_tp_rwkv"] = tp_rw_launches[name]
        if name == "quant_matmul":
            check(tp_launches[name] > 0 and tp_pool_launches[name] > 0
                  and tp_moe_launches[name] > 0 and tp_rw_launches[name] > 0,
                  ("the TP paths", name))
        else:
            check(tp_launches[name] == tp_pool_launches[name] == tp_moe_launches[name]
                  == tp_rw_launches[name] == 0, ("off the TP paths", name))
        # the QEmbed instance's paged serve: K1 and K2 on every step
        kernels[-1]["launches_qembed"] = qe_launches[name]
        if name in ("paged_attention", "quant_matmul"):
            check(qe_launches[name] > 0, ("the QEmbed path", name))
        else:
            check(qe_launches[name] == 0, ("off the QEmbed path", name))
        # the granite path (granite_main_path's int8 run, the session): K1
        # on its `mma` design and K2
        # the long-context decode (long_decode): K2 and K3 only; over its cache
        # split along the positions (seq_split_decode): K2 only
        kernels[-1]["launches_long_decode"] = ld_launches[name]
        kernels[-1]["launches_seq_split_decode"] = ss_launches[name]
        # the int8 instance with its slots over "pod" and "data": K2 only
        kernels[-1]["launches_multi_pod_engine"] = mp_launches[name]
        if name == "quant_matmul":
            check(ss_launches[name] > 0 and mp_launches[name] > 0,
                  ("the sequence split and the pod mesh", name))
        else:
            check(ss_launches[name] == mp_launches[name] == 0,
                  ("off the sequence split and the pod mesh", name))
        kernels[-1]["launches_granite"] = gr_launches[name]
        kernels[-1]["launches_granite_session"] = gr_sess_launches[name]
        if name in ("paged_attention", "quant_matmul"):
            check(gr_launches[name] > 0 and gr_sess_launches[name] > 0, ("the granite path", name))
        else:
            check(gr_launches[name] == gr_sess_launches[name] == 0, ("off the granite path", name))
        g48 = {"paged_attention": k1g, "flash_attention": k3g}.get(name)
        if g48 is not None:
            kernels[-1]["g48"] = {k: g48[k] for k in (
                "variant", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "bound_share", "cases", "max_rel_err", "max_abs_err", "timed")}
            if name == "paged_attention":
                kernels[-1]["g48"]["L1024"] = g48["L1024"]
        d112 = {"paged_attention": k1h, "flash_attention": k3h}.get(name)
        if d112 is not None:
            kernels[-1]["d112"] = {k: d112[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_share",
                "cases", "max_rel_err", "max_abs_err", "timed")}
            if name == "paged_attention":
                kernels[-1]["d112"]["L1024"] = d112["L1024"]
        if line["name"] == "quant_matmul":
            kernels[-1]["variants_moe"] = {k.split(".")[1]: n
                                           for k, n in moe_variants_run.items()
                                           if k.startswith("quant_matmul.")}
            kernels[-1]["experts"] = {k: kx[k] for k in (
                "E", "C", "K", "N", "variant", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "bound_share", "prefill", "cases", "max_rel_err", "max_abs_err")}
            kernels[-1]["experts"]["cases_seen"] = len(kx_seen["cases"])
            kernels[-1]["experts"]["max_rel_err_seen"] = kx_seen["max_rel_err"]
            # every shape of the hybrid path, and zamba2's in_proj timed
            kernels[-1]["hybrid"] = {"cases_seen": len(kq_seen["cases"]),
                                     "max_rel_err_seen": kq_seen["max_rel_err"],
                                     "max_abs_err_seen": kq_seen["max_abs_err"],
                                     "decode": kq_seen["decode"],
                                     "prefill": kq_seen["prefill"]}
            # every shape of the rwkv path, and its channel-mix cm.wv timed
            # (pruned by ffn75 to groups of 120, on fma; unpruned, groups of 128)
            kernels[-1]["rwkv"] = {"cases_seen": len(kq_rwkv["cases"]),
                                   "max_rel_err_seen": kq_rwkv["max_rel_err"],
                                   "max_abs_err_seen": kq_rwkv["max_abs_err"],
                                   "g120_shapes_seen": len(kq_rwkv["g120_shapes"]),
                                   **kq_rwkv["timed"]}
            # every shape of the vlm and encdec paths; paligemma's wi and
            # whisper's unembed (N 51865, on fma) timed
            # every shape of the granite path; its wi and untied unembed timed
            kernels[-1]["granite"] = {"cases_seen": len(kq_gr["cases"]),
                                      "max_rel_err_seen": kq_gr["max_rel_err"],
                                      "max_abs_err_seen": kq_gr["max_abs_err"],
                                      **kq_gr["timed"]}
            # every piece shape of the sharded main path, each (K, N) timed
            kernels[-1]["tp"] = {"cases_seen": len(kq_tp["cases"]),
                                 "max_rel_err_seen": kq_tp["max_rel_err"],
                                 "max_abs_err_seen": kq_tp["max_abs_err"],
                                 "k2_per_step": tp_line["k2_per_step"],
                                 "k2_per_step_unsharded": tp_line["k2_per_step_unsharded"],
                                 "variants": tp_variants, **kq_tp["timed"]}
            # every piece shape of the rwkv mesh engine, each (K, N) timed
            kernels[-1]["tp_rwkv"] = {"cases_seen": len(kq_tp_rw["cases"]),
                                      "max_rel_err_seen": kq_tp_rw["max_rel_err"],
                                      "max_abs_err_seen": kq_tp_rw["max_abs_err"],
                                      "k2_per_step": tp_rw_line["k2_per_step"],
                                      "k2_per_step_unsharded": tp_rw_line["k2_per_step_unsharded"],
                                      "variants": tp_rw_line["variants"], **kq_tp_rw["timed"]}
            kernels[-1]["vlm_encdec"] = {"cases_seen_vlm": kq_ve["cases_vlm"],
                                         "cases_seen_encdec": kq_ve["cases_encdec"],
                                         "max_rel_err_seen": kq_ve["max_rel_err"],
                                         "max_abs_err_seen": kq_ve["max_abs_err"],
                                         **kq_ve["timed"]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "host": host_cpus(), "sass": sass, "ptxas": ptxas,
                   "kernels": kernels,
                   "quant_matmul_cases": k2_cases,
                   "paged_attention_cases": k1_cases, "block_sparse_matmul_cases": k4_cases,
                   "flash_attention_cases": k3_cases, "kernel_lines": [k1, k2, k3, k4],
                   "main_path": main_line, "whole_step": step_line,
                   "decode_profile": prof_line, "block_sparse": bs_line,
                   "whole_step_block_sparse": bs_step_line,
                   "decode_profile_block_sparse": bs_prof_line, "long_prefill": long_line,
                   "olap_session": olap_line, "olap_session_variants": olap_variants,
                   "olap_f32_parity": parity_line, "olap_pool_fleet": fleet_line,
                   "olap_pool_session": pool_line, "olap_pool_f32_parity": pool_parity_line,
                   "service_full_width": svc_full_line, "train_parity": train_parity_line,
                   "train_full_width": train_full_line, "train_tiny_olap": tiny_line,
                   "service_trained": svc_line, "examples": ex_line,
                   "quant_matmul_experts": kx, "quant_matmul_experts_cases": kx_cases,
                   "quant_matmul_experts_seen": kx_seen,
                   "moe_main_path": moe_line, "moe_whole_step": moe_step_line,
                   "moe_decode_profile": moe_prof_line, "moe_session": moe_sess_line,
                   "moe_f32_parity": moe_parity_line,
                   "paged_attention_d112": k1h, "paged_attention_d112_cases": k1h_cases,
                   "flash_attention_d112": k3h, "flash_attention_d112_cases": k3h_cases,
                   "hybrid_main_path": hy_line, "hybrid_variants": hy_variants,
                   "hybrid_whole_step": hy_step_line, "hybrid_contiguous": hy_contig_line,
                   "hybrid_decode_profile": hy_prof_line, "hybrid_long_prefill": hy_long_line,
                   "hybrid_session": hy_sess_line, "hybrid_f32_parity": hy_parity_line,
                   "quant_matmul_seen": kq_seen,
                   "rwkv_main_path": rw_line, "rwkv_whole_step": rw_step_line,
                   "rwkv_decode_profile": rw_prof_line, "rwkv_session": rw_sess_line,
                   "quant_matmul_rwkv": kq_rwkv, "rwkv_f32_parity": rw_parity_line,
                   "vlm_main_path": vl_line, "vlm_whole_step": vl_step_line,
                   "vlm_decode_profile": vl_prof_line, "vlm_session": vl_sess_line,
                   "vlm_f32_parity": vl_parity_line, "encdec_main_path": ed_line,
                   "encdec_decode_profile": ed_prof_line, "encdec_build": ed_build_line,
                   "encdec_f32_parity": ed_parity_line, "quant_matmul_vlm_encdec": kq_ve,
                   "paged_attention_g48": k1g, "paged_attention_g48_cases": k1g_cases,
                   "flash_attention_g48": k3g, "flash_attention_g48_cases": k3g_cases,
                   "granite_main_path": gr_line, "granite_whole_step": gr_step_line,
                   "granite_decode_profile": gr_prof_line, "granite_session": gr_sess_line,
                   "quant_matmul_granite": kq_gr, "granite_f32_parity": gr_parity_line,
                   "long_decode": ld_line, "seq_split_decode": ss_line,
                   "multi_pod_engine": mp_line,
                   "qembed_serve": qe_line, "train_family_parity": family_parity,
                   "static_analysis": sa_line, "static_analysis_rwkv": sa_rw_line,
                   "train_full_width_families": family_full,
                   "tp_main_path": tp_line, "tp_kernel_shapes": kq_tp, "tp_pool": tp_pool_line,
                   "parallel_training": par_line, "train_split_fallbacks": split_line,
                   "train_position_split": position_line,
                   "tp_f32_parity": tp_parity_line,
                   "tp_moe": tp_moe_line, "tp_rwkv": tp_rw_line,
                   "tp_rwkv_kernel_shapes": kq_tp_rw,
                   "phase_seconds": seconds, "phase_memory": memory,
                   "seconds": time.time() - t_start}, f, indent=1)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
