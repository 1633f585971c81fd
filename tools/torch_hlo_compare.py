"""The port's train-step collective count beside the reference's compiled HLO.

The reference compiles its data-parallel train step on a host mesh of
forced CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``)
as its dry run builds a train cell (``launch/dryrun.py``: activations
sequence-sharded over "model", the streamed cross-entropy, one
microbatch, layers unrolled), and its ``launch/hlo_analysis.py`` reads the
result bytes per collective kind from the compiled per-device HLO.  The
port counts the same step analytically (``roofline.train_collectives``
on meta tensors).  The two conventions differ (that function's docstring
states the mapping); this prints both by kind, not a gate.

The reference runs in a process of its own (``--reference``), which sets
the flag before JAX starts; nothing of the reference is changed.

Usage:
  PYTHONPATH=src python tools/torch_hlo_compare.py [--arch gemma2-2b] [--layers 2]
      [--batch 4] [--seq 64] [--mesh 2,4] [--out results/torch_hlo_compare.json]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _largest_divisor(n: int, cap: int) -> int:
    return max(d for d in range(1, cap + 1) if n % d == 0)


def _xent_chunk(cfg, seq: int) -> int:
    """The reference dry run's streamed cross-entropy chunk."""
    if cfg.vocab_size >= 32000 and cfg.family in ("dense", "moe", "vlm"):
        return _largest_divisor(seq, 1024)
    return 0


def _largest(hlo: str, HA, top: int) -> list:
    """The ``top`` largest collectives of an HLO text: [kind, result
    shape, bytes], by the reference parser's rules (a "-start" skipped)."""
    found = [(m.group(2), m.group(1), HA._shape_bytes(m.group(1)))
             for m in HA._COLL_RE.finditer(hlo) if m.group(3) != "-start"]
    return [list(f) for f in sorted(found, key=lambda f: -f[2])[:top]]


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
    shape = tuple(int(s) for s in args.mesh.split(","))
    # a mesh of Auto axes (``jax.make_mesh`` gives Explicit ones on this
    # JAX, which the reference's sharding constraints refuse)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                             ("data", "model"))
    base = registry.get_config(args.arch)
    cfg = base.replace(n_layers=args.layers, scan_unroll=True,
                       **({"attn_pattern": base.attn_pattern[:args.layers]}
                          if base.attn_pattern else {}))
    out, largest = {}, {}
    for fsdp in (False, True):
        with mesh:
            SH.set_activation_sharding(NamedSharding(mesh, P(SH.dp_axes(mesh), "model", None)))
            sds = jax.ShapeDtypeStruct
            batch = {"tokens": sds((args.batch, args.seq), jnp.int32),
                     "labels": sds((args.batch, args.seq), jnp.int32)}
            batch_sh = SH.batch_shardings(cfg, batch, mesh)
            params = jax.eval_shape(lambda: api.init_params(jax.random.PRNGKey(0), cfg))
            param_sh = SH.param_shardings(cfg, params, mesh, fsdp=fsdp)
            opt = OPT.adamw()
            opt_sds = jax.eval_shape(opt.init, params)
            opt_sh = SH.opt_state_shardings(param_sh, mesh, "adamw")
            step = make_train_step(cfg, opt, xent_chunk=_xent_chunk(cfg, args.seq))
            jitted = jax.jit(step, in_shardings=(param_sh, opt_sh, batch_sh,
                                                 NamedSharding(mesh, P())),
                             donate_argnums=(0, 1))
            compiled = jitted.lower(params, opt_sds, batch,
                                    sds((), jnp.int32)).compile()
            hlo = compiled.as_text()
            out[str(fsdp)] = HA.collective_bytes(hlo)
            largest[str(fsdp)] = _largest(hlo, HA, args.top)
            SH.set_activation_sharding(None)
    return {"bytes": out, "largest": largest}


def port(args) -> dict:
    """{fsdp: train_collectives report} of the port's count at the shape."""
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import make_mesh
    base = registry.get_config(args.arch)
    cfg = base.replace(n_layers=args.layers,
                       **({"attn_pattern": base.attn_pattern[:args.layers]}
                          if base.attn_pattern else {}))
    shape = tuple(int(s) for s in args.mesh.split(","))
    mesh = make_mesh(shape, ("data", "model"), device="meta")
    params, _ = RL.meta_instance(cfg)
    step = RL.TrainStep(args.batch, args.seq, xent_chunk=_xent_chunk(cfg, args.seq))
    out = {}
    for fsdp in (False, True):
        placed = SH.place(params, SH.param_shardings(cfg, params, mesh, fsdp=fsdp))
        r = RL.train_collectives(placed, cfg, step)
        out[str(fsdp)] = {k: r[k] for k in ("bytes", "calls", "breakdown", "split")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="2,4")
    ap.add_argument("--reference", action="store_true",
                    help="compile the reference's step and print its HLO counts (JAX)")
    ap.add_argument("--top", type=int, default=6,
                    help="list the reference's largest collectives")
    ap.add_argument("--out", default="results/torch_hlo_compare.json")
    args = ap.parse_args(argv)
    if args.reference:
        print("REFERENCE " + json.dumps(reference(args)), flush=True)
        return 0
    n = 1
    for s in args.mesh.split(","):
        n *= int(s)
    env = {**os.environ, "XLA_FLAGS": f"--xla_force_host_platform_device_count={n}",
           "JAX_PLATFORMS": "cpu"}
    cmd = [sys.executable, os.path.abspath(__file__), "--reference", "--arch", args.arch,
           "--layers", str(args.layers), "--batch", str(args.batch), "--seq", str(args.seq),
           "--mesh", args.mesh, "--top", str(args.top)]
    done = subprocess.run(cmd, env=env, capture_output=True, text=True, check=True)
    got = json.loads(next(line for line in done.stdout.splitlines()
                          if line.startswith("REFERENCE "))[len("REFERENCE "):])
    ref = got["bytes"]
    ours = port(args)
    res = {"shape": vars(args), "reference_hlo": ref, "reference_largest": got["largest"],
           "port": ours}
    for fsdp in ("False", "True"):
        kinds = sorted(set(ref[fsdp]) | set(ours[fsdp]["bytes"]))
        print(f"fsdp={fsdp}: dp positions {ours[fsdp]['split']}")
        for k in kinds:
            print(f"  {k:18s} reference HLO {ref[fsdp].get(k, 0):>16,.0f}   port "
                  f"{ours[fsdp]['bytes'].get(k, 0):>16,.0f} in {ours[fsdp]['calls'].get(k, 0)} "
                  f"calls")
        for phase, kb in ours[fsdp]["breakdown"].items():
            print(f"    port {phase}: " + ", ".join(f"{k} {v:,.0f}" for k, v in kb.items()))
        for kind, shape, nbytes in got["largest"][fsdp]:
            print(f"    reference's largest: {kind} {shape} {nbytes:,.0f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
