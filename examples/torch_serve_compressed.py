"""Serve a workload with Baseline vs IOLM-DB-Perf vs IOLM-DB-Acc on the
PyTorch port.

    PYTHONPATH=src python examples/torch_serve_compressed.py --task correct
    PYTHONPATH=src python examples/torch_serve_compressed.py --device cpu --rows 8

Runs the full policy search for the chosen workload and serves the same
batch of rows through all three models on the paged ``Engine`` (the
paged-attention CUDA kernel on the card, and the int8 one where an int8
candidate is picked), printing the Table-1-style trade-off live
(``examples/serve_compressed.py`` on the port).  ``--temperature/--top-k``
exercise the sampler inside the engine's decode step (0 = greedy, the
default).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_common as common
from repro_torch.core.compressed import param_bytes
from repro_torch.serving.sampler import SamplingConfig
from repro_torch.training import data as D


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="correct", choices=("summarize", "correct", "join"))
    ap.add_argument("--rows", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    sampling = SamplingConfig(temperature=args.temperature, top_k=args.top_k, seed=args.seed)

    cfg, params, tok = common.load_model(device=args.device)
    rows = D.eval_rows(args.task, args.rows)
    prompts = [D.PROMPTS[args.task] + r.text for r in rows]

    outcome = common.optimize_for(args.task, cfg, params, tok, device=args.device)
    print(outcome.table())

    models = {"Baseline": (params, cfg, param_bytes(params))}
    for nm, cand in (("IOLM-DB-Perf", outcome.perf), ("IOLM-DB-Acc", outcome.acc)):
        if cand:
            models[nm] = (cand.params, cand.cfg, cand.result.bytes)

    print(f"\nserving {len(prompts)} rows of '{args.task}':")
    base_rps = None
    engines = {}
    for nm, (p, c, nbytes) in models.items():
        eng = common.make_engine(p, c, tok, sampling=sampling, device=args.device)
        t0 = time.time()
        outs = eng.generate(prompts, max_new=common.MAX_NEW[args.task])
        rps = len(prompts) / (time.time() - t0)
        base_rps = base_rps or rps
        acc = common.task_accuracy(outs, rows)
        print(f"  {nm:14s} {nbytes / 1e6:7.2f} MB  acc={acc:.2f}  "
              f"{rps:6.2f} rows/s ({rps / base_rps:.2f}x)  "
              f"e.g. {outs[0]!r}")
        engines[nm] = eng
    return outcome, engines


if __name__ == "__main__":
    main()
