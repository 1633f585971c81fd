"""End-to-end OLAP queries on the PyTorch port: LLM operators inside
queries, instance-optimized.

    PYTHONPATH=src python examples/torch_olap_queries.py [--no-optimize]
    PYTHONPATH=src python examples/torch_olap_queries.py --device cpu --rows 6

Loads (or trains) the OLAP-task model, builds tables, and runs the
paper's three workloads through the Query pipeline
(``examples/olap_queries.py`` on the port):

  Q1  SELECT review, LLM('summarize: ' || review) FROM reviews
  Q2  SELECT lang,  LLM('fix: ' || lang)          FROM commits
  Q3  SELECT * FROM vendors a FUZZY JOIN suppliers b ON LLM(a.name, b.name)
  Q4  SELECT lang, LLM(...) FROM commits WHERE status = 'ok'
      -- EXPLAINed first: the semantic optimizer pushes the status
      -- filter below the LLM op and dedups distinct inputs, so the
      -- model runs once per unique surviving value

With optimization ON, each query triggers the IOLM-DB workflow first
(calibrate on its own rows -> recipe search -> compressed engine); the
session log shows what was picked.  ``--no-plan-rules`` disables the
plan optimizer.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_common as common
from repro_torch.olap.query import IOLMSession, Query
from repro_torch.olap.table import Table
from repro_torch.training.data import PROMPTS, workload_rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-optimize", action="store_true")
    ap.add_argument("--no-plan-rules", action="store_true",
                    help="disable the semantic plan optimizer")
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg, params, tok = common.load_model(device=args.device)
    session = IOLMSession(params, cfg, tokenizer=tok, objective="perf",
                          acc_floor=0.85,
                          engine_kw=dict(slots=8, max_len=160, buckets=(48, 96, 128)),
                          device=args.device)
    optimize = not args.no_optimize

    # Q1: summarization
    reviews = Table({"review": [r.text for r in workload_rows("summarize", args.rows)]})
    t0 = time.time()
    out1 = Query(reviews, session, optimize=optimize) \
        .llm_map("review", prompt=PROMPTS["summarize"], out_col="summary") \
        .run()
    print(f"\nQ1 summarize ({time.time() - t0:.1f}s):")
    print(out1.select(["summary"]).head(4))

    # Q2: data correction
    commits = Table({"lang": [r.text for r in workload_rows("correct", args.rows)]})
    t0 = time.time()
    out2 = Query(commits, session, optimize=optimize) \
        .llm_correct("lang", prompt=PROMPTS["correct"]).run()
    print(f"\nQ2 correct ({time.time() - t0:.1f}s):")
    print(out2.head(4))

    # Q3: fuzzy join
    pairs = workload_rows("join", args.rows)
    left = Table({"name": [p.text.split(" | ")[0] for p in pairs]})
    right = Table({"name": [p.text.split(" | ")[1] for p in pairs]})
    t0 = time.time()
    out3 = Query(left, session, optimize=optimize) \
        .llm_join(right, ("name", "name"), prompt=PROMPTS["join"]).run()
    print(f"\nQ3 fuzzy join ({time.time() - t0:.1f}s): "
          f"{len(out3)} matched pairs")
    print(out3.head(4))

    # Q4: the semantic optimizer at work: EXPLAIN, then run.  The status
    # filter declares its read set, so it pushes below the LLM op; the
    # duplicated lang values dedup to one invocation each.
    commits4 = Table({
        "lang": [commits["lang"][i % max(1, args.rows // 2)] for i in range(args.rows)],
        "status": ["ok" if i % 2 == 0 else "wip" for i in range(args.rows)]})
    q4 = Query(commits4, session, optimize=optimize,
               optimize_plan=not args.no_plan_rules) \
        .llm_correct("lang", prompt=PROMPTS["correct"], max_new=8) \
        .filter(lambda r: r["status"] == "ok", columns=["status"])
    print("\nQ4 EXPLAIN:")
    print(q4.explain())
    t0 = time.time()
    out4 = q4.run()
    n_inv = sum(s.invocations for s in q4.last_run_stats)
    print(f"\nQ4 correct+filter ({time.time() - t0:.1f}s): "
          f"{len(out4)} rows, {n_inv} LLM invocations "
          f"for {len(commits4)} input rows")
    print(out4.head(4))

    print("\nsession log:")
    for line in session.log:
        print(" ", line)
    return {"session": session, "q4": q4, "commits4": commits4, "out4": out4,
            "invocations": n_inv}


if __name__ == "__main__":
    main()
