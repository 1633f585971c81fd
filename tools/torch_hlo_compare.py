"""The port's train-step collective count beside the reference's compiled HLO.

The reference compiles its data-parallel train step on a host mesh of
forced CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``)
as its dry run builds a train cell (``launch/dryrun.py``: activations
sequence-sharded over "model", the streamed cross-entropy, layers
unrolled; one microbatch unless ``--microbatches`` asks for more), and its
``launch/hlo_analysis.py`` reads the result bytes per collective kind
from the compiled per-device HLO.  The port counts the same step
analytically (``roofline.train_collectives`` on meta tensors): the single
controller's sum over every call, what one device's program holds of it
(``per_device``), and the gathers XLA never emits (``port_only``).  The
CPU compile differs from a device's program in ways each named by
``roofline.hlo_terms``; per kind the tool prints ``per_device`` plus those
terms beside the HLO (``roofline.hlo_match``: within 2%, or both under 1%
of the HLO's total and listed).

Every family's batch is the reference dry run's train batch
(``configs/base.py`` ``input_specs``): ``--seq`` text tokens a row, a
vlm's ``img_embs`` [B, n_img, d] ahead of them, an encdec's
``enc_inputs`` [B, seq, d] frames; ``--layers`` cuts an encdec's encoder
and decoder each.  A ``--batch`` that the dp axes do not divide runs the
reference's fallback (its positions over "data"); ``--microbatches``
whose rows do not split over the dp positions runs XLA's placement of
the ``[M, B/M]`` reshape.  Both are held by the same rule as the default
shape (``tests/test_torch_dryrun_hlo_<family>.py``), except the residue
ROADMAP's queue 3 lists.

The reference runs in a process of its own (``--reference``), which sets
the flag before JAX starts; nothing of the reference is changed.

Usage:
  PYTHONPATH=src python tools/torch_hlo_compare.py [--arch gemma2-2b] [--layers 2]
      [--batch 4] [--seq 64] [--mesh 2,4] [--microbatches 1]
      [--hlo-dir DIR] [--out results/torch_hlo_compare.json]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _largest(hlo: str, HA, top: int) -> list:
    """The ``top`` largest collectives of an HLO text: [kind, result
    shape, bytes], by the reference parser's rules (a "-start" skipped)."""
    found = [(m.group(2), m.group(1), HA._shape_bytes(m.group(1)))
             for m in HA._COLL_RE.finditer(hlo) if m.group(3) != "-start"]
    return [list(f) for f in sorted(found, key=lambda f: -f[2])[:top]]


def _cut(base, layers: int):
    """``base`` cut to ``layers`` layers (an encdec's encoder and decoder
    each), its attention pattern with it."""
    kw = {"n_layers": layers}
    if base.attn_pattern:
        kw["attn_pattern"] = base.attn_pattern[:layers]
    if base.family == "encdec":
        kw.update(n_enc_layers=layers, n_dec_layers=layers)
    return base.replace(**kw)


def _positions(cfg, args) -> int:
    """A row's positions: the text and a vlm's image ahead of it."""
    return args.seq + (cfg.n_img_tokens if cfg.family == "vlm" else 0)


def _mesh_axes(shape) -> tuple:
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def batch_shapes(cfg, args) -> dict:
    """{name: (shape, "int32" or "float")} of the train batch, as both dry
    runs' ``input_specs`` build a train cell's: ``--seq`` text tokens a
    row, a vlm's ``img_embs`` [B, n_img, d] ahead of them, an encdec's
    ``enc_inputs`` [B, seq, d] frames."""
    B, S = args.batch, args.seq
    out = {"tokens": ((B, S), "int32"), "labels": ((B, S), "int32")}
    if cfg.family == "vlm":
        out["img_embs"] = ((B, cfg.n_img_tokens, cfg.d_model), "float")
    elif cfg.family == "encdec":
        out["enc_inputs"] = ((B, S, cfg.d_model), "float")
    return out


def reference(args) -> dict:
    """{fsdp: {kind: bytes}} of the reference's compiled step and
    {fsdp: its largest collectives} (runs JAX)."""
    import numpy as np

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import registry
    from repro.distributed import sharding as SH
    from repro.launch import hlo_analysis as HA
    from repro.models import api
    from repro.training import optimizer as OPT
    from repro.training.train_loop import make_train_step
    from repro_torch.launch.dryrun import xent_chunk
    shape = tuple(int(s) for s in args.mesh.split(","))
    # a mesh of Auto axes (``jax.make_mesh`` gives Explicit ones on this
    # JAX, which the reference's sharding constraints refuse)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                             _mesh_axes(shape))
    cfg = _cut(registry.get_config(args.arch), args.layers).replace(scan_unroll=True)
    out, largest = {}, {}
    for fsdp in (False, True):
        with mesh:
            SH.set_activation_sharding(NamedSharding(mesh, P(SH.dp_axes(mesh), "model", None)))
            sds = jax.ShapeDtypeStruct
            batch = {k: sds(s, dt if dt == "int32" else cfg.dtype)
                     for k, (s, dt) in batch_shapes(cfg, args).items()}
            batch_sh = SH.batch_shardings(cfg, batch, mesh)
            params = jax.eval_shape(lambda: api.init_params(jax.random.PRNGKey(0), cfg))
            param_sh = SH.param_shardings(cfg, params, mesh, fsdp=fsdp)
            opt = OPT.adamw()
            opt_sds = jax.eval_shape(opt.init, params)
            opt_sh = SH.opt_state_shardings(param_sh, mesh, "adamw")
            step = make_train_step(cfg, opt, xent_chunk=xent_chunk(cfg, _positions(cfg, args)),
                                   microbatches=args.microbatches)
            jitted = jax.jit(step, in_shardings=(param_sh, opt_sh, batch_sh,
                                                 NamedSharding(mesh, P())),
                             donate_argnums=(0, 1))
            compiled = jitted.lower(params, opt_sds, batch,
                                    sds((), jnp.int32)).compile()
            hlo = compiled.as_text()
            if args.hlo_dir:
                os.makedirs(args.hlo_dir, exist_ok=True)
                with open(os.path.join(args.hlo_dir, f"{args.arch}_fsdp{fsdp}.hlo"), "w") as f:
                    f.write(hlo)
            out[str(fsdp)] = HA.collective_bytes(hlo)
            largest[str(fsdp)] = _largest(hlo, HA, args.top)
            SH.set_activation_sharding(None)
    return {"bytes": out, "largest": largest}


def port(args) -> dict:
    """{fsdp: train_collectives report with its ``hlo_terms``} of the
    port's count at the shape (meta tensors)."""
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.dryrun import xent_chunk
    from repro_torch.launch.mesh import make_mesh
    cfg = _cut(registry.get_config(args.arch), args.layers)
    shape = tuple(int(s) for s in args.mesh.split(","))
    mesh = make_mesh(shape, _mesh_axes(shape), device="meta")
    params, _ = RL.meta_instance(cfg)
    step = RL.TrainStep(args.batch, args.seq, args.microbatches,
                        xent_chunk=xent_chunk(cfg, _positions(cfg, args)),
                        enc_len=args.seq if cfg.family == "encdec" else 0)
    out = {}
    for fsdp in (False, True):
        placed = SH.place(params, SH.param_shardings(cfg, params, mesh, fsdp=fsdp))
        r = RL.train_collectives(placed, cfg, step)
        keep = ("bytes", "calls", "breakdown", "split", "split_by", "per_device", "port_only")
        out[str(fsdp)] = {**{k: r[k] for k in keep}, "terms": RL.hlo_terms(placed, cfg, step, r)}
    return out


def run_reference(args) -> dict:
    """The ``--reference`` process's result, at the forced device count."""
    n = 1
    for s in args.mesh.split(","):
        n *= int(s)
    env = {**os.environ, "XLA_FLAGS": f"--xla_force_host_platform_device_count={n}",
           "JAX_PLATFORMS": "cpu"}
    cmd = [sys.executable, os.path.abspath(__file__), "--reference", "--arch", args.arch,
           "--layers", str(args.layers), "--batch", str(args.batch), "--seq", str(args.seq),
           "--mesh", args.mesh, "--microbatches", str(args.microbatches), "--top", str(args.top)]
    if args.hlo_dir:
        cmd += ["--hlo-dir", args.hlo_dir]
    done = subprocess.run(cmd, env=env, capture_output=True, text=True, check=True)
    return json.loads(next(line for line in done.stdout.splitlines()
                           if line.startswith("REFERENCE "))[len("REFERENCE "):])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="2,4")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reference", action="store_true",
                    help="compile the reference's step and print its HLO counts (JAX)")
    ap.add_argument("--top", type=int, default=6,
                    help="list the reference's largest collectives")
    ap.add_argument("--hlo-dir", default="",
                    help="write the reference's compiled HLO texts there")
    ap.add_argument("--out", default="results/torch_hlo_compare.json")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.reference:
        print("REFERENCE " + json.dumps(reference(args)), flush=True)
        return 0
    got = run_reference(args)
    ref = got["bytes"]
    ours = port(args)
    from repro_torch.launch import roofline as RL
    match = {f: RL.hlo_match(ref[f], ours[f]["per_device"], ours[f]["terms"]) for f in ref}
    res = {"shape": vars(args), "reference_hlo": ref, "reference_largest": got["largest"],
           "port": ours, "match": match}
    for fsdp in ("False", "True"):
        mine = ours[fsdp]
        print(f"fsdp={fsdp}: {mine['split']} dp positions, split by {mine['split_by']}")
        print(f"  {'kind':18s} {'reference HLO':>16s} {'per_device':>16s} {'+ terms':>16s} "
              f"{'controller':>16s} calls  status")
        for k, m in match[fsdp].items():
            err = f" {m['rel_err']:+.4%}" if m["rel_err"] is not None else ""
            print(f"  {k:18s} {m['hlo']:>16,.0f} {m['per_device']:>16,.0f} {m['sum']:>16,.0f} "
                  f"{mine['bytes'].get(k, 0):>16,.0f} {mine['calls'].get(k, 0):>5d}  "
                  f"{m['status']}{err}")
        for name, kb in mine["terms"].items():
            print(f"    term {name}: " + ", ".join(f"{k} {v:+,.0f}" for k, v in kb.items()))
        for name, kb in mine["port_only"].items():
            print(f"    port_only {name}: " + ", ".join(f"{k} {v:,.0f}" for k, v in kb.items()))
        for phase, kb in mine["breakdown"].items():
            print(f"    controller {phase}: " + ", ".join(f"{k} {v:,.0f}" for k, v in kb.items()))
        for kind, shape, nbytes in got["largest"][fsdp]:
            print(f"    reference's largest: {kind} {shape[:120]} {nbytes:,.0f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
