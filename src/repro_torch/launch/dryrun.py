"""Dry run of every (arch x shape x mesh) cell on the production meshes.

The counterpart of the reference's ``launch/dryrun.py``.  The reference
lowers and compiles each cell on 512 fake devices, then reads its memory
and roofline terms from XLA.  The port has no compiler, so it builds
each cell's params, optimizer state, cache and batch on the ``meta``
device (shapes, no storage), applies the sharding rules
(``distributed/sharding.py``) over the production mesh
(``launch/mesh.py``: ``(16, 16)`` single pod, ``(2, 16, 16)`` multi-pod)
and reports, per cell:

- the bytes one position holds, from the rule table: params (the int8
  ``QTensor`` twin of every compressible leaf with ``--compress
  wbits=8``), the optimizer state for train shapes (AdamW, Adafactor above
  50 B params; FSDP above 5 B, as the reference) and the cache for decode
  shapes.  The cache is the reference's compact one
  (``init_cache(compact_local=True)``): a local layer keeps a circular
  buffer of its window, a global layer the whole context;
- whether that fits an 80 GB card;
- the roofline terms of ``launch/roofline.py``: the cell's model FLOPs
  shared over the mesh, the bytes above read once, and the result bytes
  of every gather and reduce the sharded step runs
  (``roofline.collective_bytes``: a decode step's ``B`` rows, a
  prefill's ``B * S``).  A train cell counts the whole data-parallel step
  over the params placed with the cell's own ``fsdp``
  (``roofline.train_collectives``: its rows over the dp axes, the
  forward, the backward's conjugates and rematerialized blocks, FSDP's
  per-use gathers, and the gradients' all-reduces and reduce-scatters),
  says ``train_collectives: counted`` and gives the
  ``collective_breakdown`` by forward, backward and gradients.  A decode
  step runs over the cache placed as a mesh engine places its own
  (``models/sharded_cache.py`` ``place_slot_state``; the engine keeps
  absolute slots, the rules are the same, and the sharded attention
  writes a compact local buffer at slot ``pos % T``): its
  attention over the k/v pieces, and the rwkv and zamba2 cells' scans
  over their recurrent pieces (``S``/``h`` over heads and slots, the
  carries and conv window over slots), whose gathers are counted too;
  ``long_500k``'s one row puts the positions over "data" (the sequence
  split: each piece's softmax sums merged), and the multi-pod mesh the
  slots over "pod" and "data".  Every decode cell says
  ``cache_collectives: counted``.

Activations are not counted.  It touches no card.

Usage:
  python -m repro_torch.launch.dryrun --cell gemma2-2b:decode_32k:single
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
                                      [--arch ARCH] [--out results/torch_dryrun.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, Tuple

import torch

from repro_torch.configs import registry
from repro_torch.distributed import sharding as SH
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.tree import flatten_with_path

SHAPES = {
    "train_4k": RL.ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": RL.ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": RL.ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": RL.ShapeSpec("long_500k", 524288, 1, "decode"),
}
BIG_FOR_ADAFACTOR = 50e9     # params; arctic trains with adafactor + fsdp
FSDP_ABOVE = 5e9             # params; train cells shard weights over data above it
CARD_BYTES = 80e9            # one H100's memory


def shape_supported(cfg, shape: str) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; the reason if skipped."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: 500k decode KV unjustifiable"
    return True, ""


def input_specs(cfg, shape: str) -> Dict[str, torch.Tensor]:
    """Meta tensors for every model input of the cell (the reference's
    ``configs/base.py`` ``input_specs``)."""
    spec = SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len

    def t(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.family == "encdec":
        if spec.kind == "train":
            return {"enc_inputs": t((B, S, cfg.d_model), cfg.dtype),
                    "tokens": t((B, S)), "labels": t((B, S))}
        if spec.kind == "prefill":
            return {"enc_inputs": t((B, S, cfg.d_model), cfg.dtype), "tokens": t((B, 1))}
        return {"tokens": t((B, 1))}
    if cfg.family == "vlm":
        n_img = cfg.n_img_tokens
        if spec.kind == "train":
            return {"img_embs": t((B, n_img, cfg.d_model), cfg.dtype),
                    "tokens": t((B, S - n_img)), "labels": t((B, S - n_img))}
        if spec.kind == "prefill":
            return {"img_embs": t((B, n_img, cfg.d_model), cfg.dtype),
                    "tokens": t((B, S - n_img))}
        return {"tokens": t((B, 1))}
    if spec.kind == "train":
        return {"tokens": t((B, S)), "labels": t((B, S))}
    if spec.kind == "prefill":
        return {"tokens": t((B, S))}
    return {"tokens": t((B, 1))}


def quantize_specs(params, cfg):
    """Every compressible weight leaf as a meta int8 ``QTensor`` (groups of
    up to 128): the shape-level twin of the pipeline's int8 build."""
    from repro_torch.core.compressed import QTensor
    from repro_torch.core.pipeline import _is_target
    from repro_torch.core.quantize import choose_group
    from repro_torch.tree import unflatten_like
    flat = flatten_with_path(params)
    out = []
    for path, leaf in flat:
        if not _is_target(".".join(str(k) for k in path), leaf):
            out.append(leaf)
            continue
        *lead, d_in, d_out = leaf.shape
        g = choose_group(d_in, 128)
        out.append(QTensor(torch.empty((*lead, d_in, d_out), dtype=torch.int8, device="meta"),
                           torch.empty((*lead, d_in // g, d_out), dtype=torch.float32,
                                       device="meta"),
                           8, g, (d_in, d_out)))
    return unflatten_like(params, out)


def _tensors_with_shardings(tree, shardings):
    """[(tensor, NamedSharding)] of every tensor of ``tree`` (a compressed
    container's children with theirs)."""
    by_path = dict(flatten_with_path(shardings, is_leaf=SH._is_sharding))
    out = []
    for path, leaf in flatten_with_path(tree):
        sh = by_path[path]
        kids = SH._children(leaf)
        if kids is None:
            out.append((leaf, sh))
        else:
            out.extend((t, s) for (_, t), s in zip(kids, sh))
    return out


def bytes_per_position(tree, shardings) -> float:
    """Bytes one position holds of ``tree`` under ``shardings`` (every
    position holds the same under the divisibility-guarded rules)."""
    return sum(SH.spec_bytes(t.shape, t.element_size(), sh.spec, sh.mesh)
               for t, sh in _tensors_with_shardings(tree, shardings))


def _compress_cfg(cfg, compress: str):
    kv = dict(item.split("=") for item in compress.split(",") if item)
    if "experts_keep" in kv and cfg.family == "moe":
        cfg = cfg.replace(n_experts=int(kv["experts_keep"]))
    if "kv_keep" in kv:
        K2 = int(kv["kv_keep"])
        G = cfg.n_heads // cfg.n_kv_heads
        cfg = cfg.replace(n_kv_heads=K2, n_heads=K2 * G, head_dim=cfg.resolved_head_dim)
    return cfg, kv


def build_cell(arch: str, shape_name: str, mesh, compress: str = "") -> dict:
    """The cell's pieces on the ``meta`` device under ``mesh``'s rules:
    ``cfg``, ``spec``, ``params`` and ``param_shardings`` (``fsdp``),
    ``batch`` and ``batch_shardings``; a train cell's optimizer
    (``opt_kind``, ``opt_state``, ``opt_state_shardings``), a decode
    cell's compact ``cache`` and ``cache_shardings``; and ``step``, the
    step function the cell runs (``api.build_train_step``,
    ``build_prefill_step`` or ``build_serve_step``)."""
    from repro_torch.models import api
    from repro_torch.training import optimizer as OPT
    cfg, kv = _compress_cfg(registry.get_config(arch), compress)
    spec = SHAPES[shape_name]
    params, _ = RL.meta_instance(cfg)
    if "wbits" in kv:
        params = quantize_specs(params, cfg)
    fsdp = spec.kind == "train" and cfg.param_count() > FSDP_ABOVE
    batch = input_specs(cfg, shape_name)
    cell = {"cfg": cfg, "spec": spec, "params": params, "fsdp": fsdp,
            "param_shardings": SH.param_shardings(cfg, params, mesh, fsdp=fsdp),
            "batch": batch, "batch_shardings": SH.batch_shardings(cfg, batch, mesh)}
    if spec.kind == "train":
        kind = "adafactor" if cfg.param_count() > BIG_FOR_ADAFACTOR else "adamw"
        opt = OPT.adafactor() if kind == "adafactor" else OPT.adamw()
        cell.update(opt_kind=kind, opt_state=opt.init(params),
                    opt_state_shardings=SH.opt_state_shardings(cell["param_shardings"],
                                                               mesh, kind),
                    step=api.build_train_step(cfg, opt))
    elif spec.kind == "prefill":
        cell["step"] = api.build_prefill_step(cfg, spec)
    else:
        cache = api.init_cache(cfg, spec.global_batch, spec.seq_len, compact_local=True,
                               device="meta")
        cell.update(cache=cache, cache_shardings=SH.cache_shardings(cfg, cache, mesh),
                    step=api.build_serve_step(cfg, spec))
    return cell


def train_step_shape(cfg, batch) -> "RL.TrainStep":
    """The shape of the train step a train cell runs (``api.build_train_step``:
    one microbatch, no cross-entropy chunks, remat on) from its inputs."""
    B, S = batch["tokens"].shape
    enc = batch["enc_inputs"].shape[1] if "enc_inputs" in batch else 0
    return RL.TrainStep(B, S, enc_len=enc)


def run_cell(arch: str, shape_name: str, mesh_kind: str, compress: str = "") -> dict:
    """One cell's report (see the module docstring)."""
    ok, reason = shape_supported(registry.get_config(arch), shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh.size
    cell = build_cell(arch, shape_name, mesh, compress)
    cfg, spec, params, fsdp = cell["cfg"], cell["spec"], cell["params"], cell["fsdp"]
    mem = {"params": bytes_per_position(params, cell["param_shardings"])}
    batch, batch_sh = cell["batch"], cell["batch_shardings"]
    mem["batch"] = sum(SH.spec_bytes(t.shape, t.element_size(), batch_sh[k], mesh)
                       for k, t in batch.items())
    B, S = spec.global_batch, spec.seq_len
    rows = B if spec.kind == "decode" else B * S
    if spec.kind == "train":
        mem["opt_state"] = bytes_per_position(cell["opt_state"], cell["opt_state_shardings"])
    elif spec.kind == "decode":
        cache = cell["cache"]
        mem["cache"] = sum(SH.spec_bytes(t.shape, t.element_size(), s, mesh)
                           for (_, t), (_, s) in zip(flatten_with_path(cache),
                                                     flatten_with_path(cell["cache_shardings"],
                                                                       is_leaf=SH._is_spec)))
    per_position = sum(mem.values())
    state, cache_note = None, "counted"
    if cfg.family in ("rwkv", "hybrid"):
        cache_note = "counted, recurrent pieces included"
    if spec.kind == "decode":
        from repro_torch.models.sharded_cache import place_slot_state
        state = place_slot_state(cache, cfg, mesh)
    train_note = {}
    if spec.kind == "train":
        tc = RL.train_collectives(SH.place(params, cell["param_shardings"]), cfg,
                                  train_step_shape(cfg, batch))
        coll = tc["bytes"]
        train_note = {"train_collectives": "counted", "collective_breakdown": tc["breakdown"],
                      "collective_calls": tc["calls"], "dp_split": tc["split"]}
    else:
        coll = RL.collective_bytes(SH.shard_params(params, cfg, mesh), cfg, rows, state)
    mf = RL.model_flops(cfg, spec)
    roof = RL.Roofline(flops=mf / chips, bytes_accessed=per_position,
                       coll_bytes=sum(coll.values()), chips=chips, coll_detail=coll)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "ok",
            "chips": chips, "fsdp": fsdp, "compress": compress,
            "bytes_per_position": per_position,
            "param_bytes_per_position": mem["params"], "memory": mem,
            "fits": per_position <= CARD_BYTES, "card_bytes": CARD_BYTES,
            "roofline": roof.to_dict(), "model_flops": mf,
            **({"cache_collectives": cache_note} if spec.kind == "decode" else {}),
            **train_note,
            "seconds": time.time() - t0}


def _cell(key: str, compress: str) -> dict:
    arch, shape, mesh_kind = key.split(":")
    try:
        return run_cell(arch, shape, mesh_kind, compress)
    except Exception as e:        # the cell reports its failure; the run goes on
        return {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "error",
                "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", help="arch:shape:mesh  (mesh = single|multi)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--compress", default="",
                    help="e.g. wbits=8,kv_keep=2,experts_keep=30 (the reference's "
                         "DRYRUN_COMPRESS)")
    ap.add_argument("--out", default="results/torch_dryrun.json")
    args = ap.parse_args(argv)
    if args.cell:
        res = _cell(args.cell, args.compress)
        print("DRYRUN_RESULT " + json.dumps(res), flush=True)
        return 0 if res["status"] in ("ok", "skipped") else 1
    if not args.all:
        ap.print_help()
        return 2
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = [args.arch] if args.arch else list(registry.ARCH_IDS)
    results = {}
    for m in meshes:
        for a in archs:
            for s in SHAPES:
                key = f"{a}:{s}:{m}"
                results[key] = _cell(key, args.compress)
                r = results[key]
                print(f"[dryrun] {key}: {r['status']}"
                      + (f" {r['bytes_per_position'] / 1e9:.2f} GB/position, fits "
                         f"{r['fits']}, bound {r['roofline']['bound']}"
                         if r["status"] == "ok" else ""), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results.values())
    n_skip = sum(r["status"] == "skipped" for r in results.values())
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} failed / {len(results)}")
    return 0 if n_ok + n_skip == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
