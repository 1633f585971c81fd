"""Multi-tenant quickstart on the PyTorch port: N tenants' OLAP queries on
one shared pool.

    PYTHONPATH=src python examples/torch_multi_tenant.py [--rows 8] [--budget-mb N]
    PYTHONPATH=src python examples/torch_multi_tenant.py --device cpu

Three tenants each run a different LLM query (summarize / correct /
fuzzy-join) against their own table.  The session holds a byte-budgeted
``ModelPool``: every query's instance-optimized model (the ``w8`` absmax
recipe, the int8 CUDA kernel on the card) is admitted under one budget,
and a fair-share ``Scheduler`` interleaves all tenants' operators tick by
tick (``examples/multi_tenant.py`` on the port).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_common as common
from repro_torch.core.compressed import param_bytes
from repro_torch.core.pipeline import Recipe
from repro_torch.olap.query import IOLMSession, Query
from repro_torch.olap.table import Table
from repro_torch.serving.scheduler import Scheduler
from repro_torch.training.data import PROMPTS, workload_rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="pool byte budget (default: 3x the base model)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg, params, tok = common.load_model(device=args.device)
    budget = int((args.budget_mb * 1e6) if args.budget_mb
                 else 3 * param_bytes(params) + (64 << 20))
    session = IOLMSession(
        params, cfg, tokenizer=tok, acc_floor=0.85,
        recipes=[Recipe(name="w8", wbits=8, quant_method="absmax")],
        engine_kw=dict(slots=4, max_len=160, buckets=(48, 96, 128)),
        pool_budget=budget, device=args.device)

    # three tenants, three different queries
    reviews = Table({"review": [r.text for r in workload_rows("summarize", args.rows)]})
    commits = Table({"lang": [r.text for r in workload_rows("correct", args.rows)]})
    pairs = workload_rows("join", args.rows)
    left = Table({"name": [p.text.split(" | ")[0] for p in pairs]})
    right = Table({"name": [p.text.split(" | ")[1] for p in pairs]})

    queries = {
        "tenant-a": Query(reviews, session)
            .llm_map("review", prompt=PROMPTS["summarize"], out_col="summary"),
        "tenant-b": Query(commits, session)
            .llm_correct("lang", prompt=PROMPTS["correct"]),
        "tenant-c": Query(left, session)
            .llm_join(right, ("name", "name"), prompt=PROMPTS["join"]),
    }

    sched = Scheduler(session.pool, share=4)
    t0 = time.time()
    results = sched.run_queries(queries)
    dt = time.time() - t0

    print(f"\n{len(queries)} tenants in {dt:.1f}s "
          f"({sched.stats.rows} rows, {sched.stats.ticks} ticks)")
    print("tenant-a summaries:", results["tenant-a"]["summary"][:2])
    print("tenant-b fixes:    ", results["tenant-b"]["lang_fixed"][:2])
    print("tenant-c matches:  ", len(results["tenant-c"]), "pairs")

    pool = session.pool
    print(f"\npool: {len(pool)} resident models, "
          f"{pool.resident_bytes / 1e6:.1f} / {budget / 1e6:.1f} MB, "
          f"{pool.stats.evictions} evictions")
    for v in pool.resident_versions:
        print("  resident:", v)
    print("\nsession log:")
    for line in session.log:
        print(" ", line)
    return session, sched, results


if __name__ == "__main__":
    main()
