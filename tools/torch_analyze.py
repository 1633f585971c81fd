#!/usr/bin/env python
"""Static analysis of the PyTorch port: plan verifier + hot-path audit.

  python tools/torch_analyze.py --all --device cpu          # text report
  python tools/torch_analyze.py --all --format=json --out DIAG.json
  python tools/torch_analyze.py --jit --device cpu --update-baseline

The counterpart of ``tools/analyze.py`` for ``src/repro_torch`` (it
imports nothing of JAX or of the reference package).  Two layers behind
one diagnostics stream (``repro_torch/analysis/``):

``--plan``  runs the port's plan verifier over the reference's workload
suite: every optimizer rewrite is re-proved inside
``optimize(verify=True)`` and both the built and the optimized plans are
checked structurally.  A clean tree reports zero PLAN diagnostics.

``--jit``   builds the reference's tiny engine (2 layers, d_model 64)
on ``--device`` (``cuda`` by default; there without a card it raises)
and runs the hot-path audit (``analysis/jit_audit.py``): the scripted
workload through ``generate``, then the host-sync, in-place state,
host-argument, promotion, in-loop build and budget checks over every
step method of ``Engine.jit_targets()``.

The exit code gates on the **baseline** (tools/torch_analysis_baseline.json):
only findings absent from it, new debt, fail the run.  Every entry of
the baseline names its reason in ``suppress_reasons``.
``--update-baseline`` rewrites the file from the current findings and
keeps the reasons it had (review the diff like code).
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(ROOT, "src"))

DEFAULT_BASELINE = os.path.join(ROOT, "tools", "torch_analysis_baseline.json")


def plan_workloads():
    """The reference's plan suite (``tools/analyze.py``): one workload per
    optimizer rule plus mixed chains."""
    from repro_torch.olap import plan as P
    from repro_torch.olap.table import Table

    t = Table({"category": ["a", "b", "a", "a", "c", "b", "a", "c"],
               "status": ["ok", "bad", "ok", "bad", "ok", "ok",
                          "bad", "ok"]})
    right = Table({"name": ["alpha", "beta"]})
    scan = P.Scan(t)

    def m(inp, col="category", prompt="label: ", out="label", new=8):
        return P.LLMMap(input=inp, col=col, prompt=prompt, out_col=out,
                        max_new=new)

    return {
        "pushdown": P.Filter(
            input=m(scan), pred=lambda r: r["status"] == "ok",
            columns=("status",)),
        "fusion": m(m(scan), out="label2"),
        "dedup": m(scan),
        "filter_chain": P.Filter(
            input=P.LLMFilter(input=m(scan), col="status",
                              prompt="keep? ", max_new=2),
            pred=lambda r: r["status"] == "ok", columns=("status",)),
        "correct_select": P.Select(
            input=P.LLMCorrect(input=scan, col="status",
                               prompt="fix: ", out_col="status_fixed",
                               max_new=8),
            cols=("category", "status_fixed")),
        "join": P.LLMJoin(input=scan, right=right,
                          on=("category", "name"), prompt="match? ",
                          max_new=2),
    }


def run_plan_layer(workloads=None):
    from repro_torch.olap import analysis as ANA
    from repro_torch.olap import optimizer as OPT

    diags, detail = [], {}
    for name, plan in (workloads or plan_workloads()).items():
        diags.extend(ANA.verify_plan(plan))
        try:
            optimized, firings = OPT.optimize(plan, verify=True)
        except ANA.PlanVerificationError as e:
            diags.extend(e.diagnostics)
            detail[name] = {"error": str(e)}
            continue
        diags.extend(ANA.verify_plan(optimized))
        detail[name] = {"rules": [f.rule for f in firings],
                        "verified": all(f.verified for f in firings)}
    return diags, {"plan_workloads": detail}


def run_jit_layer(device: str = "cuda"):
    import torch

    from repro_torch.analysis import jit_audit as JA
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine

    dev = resolve_device(device)
    cfg = ModelConfig(name="audit", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=260, max_seq=256)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    engine = Engine(api.init_params(gen, cfg), cfg, device=dev)
    report = JA.audit_engine(engine)
    return report.diagnostics, {"jit_cache_stats": report.cache_stats,
                                "jit_budget": report.budget}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", action="store_true",
                    help="run the plan-verifier layer")
    ap.add_argument("--jit", action="store_true",
                    help="run the hot-path audit of the tiny engine")
    ap.add_argument("--all", action="store_true",
                    help="run every layer (default when none given)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the audited engine runs")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file to gate against "
                         "('' disables gating)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--out", default="",
                    help="also write the report to this path")
    args = ap.parse_args(argv)
    if args.all or not (args.plan or args.jit):
        args.plan = args.jit = True

    from repro_torch.analysis import diagnostics as D

    diags, extra = [], {}
    if args.plan:
        d, x = run_plan_layer()
        diags.extend(d)
        extra.update(x)
    if args.jit:
        d, x = run_jit_layer(args.device)
        diags.extend(d)
        extra.update(x)

    if args.baseline and os.path.exists(args.baseline):
        base = D.load_baseline(args.baseline)
    else:
        base = D.Baseline()

    if args.update_baseline:
        D.save_baseline(args.baseline, diags, suppress_codes=base.suppress_codes,
                        suppress_reasons=base.suppress_reasons)
        print(f"baseline updated: {args.baseline} "
              f"({len(diags)} finding(s) recorded)")
        return 0

    report = (D.render_json(diags, extra=extra)
              if args.format == "json" else D.render_text(diags))
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(D.render_json(diags, extra=extra) + "\n")

    new = base.new_findings(diags)
    if new:
        print(f"\n{len(new)} NEW finding(s) not in baseline "
              f"({args.baseline or 'none'}):", file=sys.stderr)
        print(D.render_text(new), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
