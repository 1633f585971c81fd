"""Quickstart on the PyTorch port: instance-optimize a model for a query.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Builds a small LM, calibrates it on a sample of query prompts, applies
three compression recipes, and shows the size/agreement trade-off, the
IOLM-DB workflow in miniature (``examples/quickstart.py`` on the port).
``w8-gptq`` runs the int8 CUDA kernel on the card; ``w8+2:4`` and
``w4+ffn75`` take the plain dequantization in both packages.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import policy as POL
from repro_torch.core.compressed import param_bytes
from repro_torch.core.pipeline import InstanceOptimizer, Recipe
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import api
from repro_torch.training.data import PROMPTS, ByteTokenizer, workload_rows

CFG = ModelConfig(name="quickstart", family="dense", n_layers=4, d_model=128, n_heads=4,
                  n_kv_heads=2, d_ff=384, vocab_size=260, max_seq=256)
RECIPES = (Recipe(name="w8-gptq", wbits=8),
           Recipe(name="w8+2:4", wbits=8, nm=(2, 4)),
           Recipe(name="w4+ffn75", wbits=4, group=32, ffn_keep_frac=0.75))


def compress_and_score(params, cfg, device="cuda", out=print):
    """Calibrate on 16 ``correct`` rows, apply each of ``RECIPES`` and
    score its greedy tokens against the uncompressed model's; prints the
    reference's lines through ``out`` and returns [(report, EvalResult)]."""
    dev = resolve_device(device)
    tok = ByteTokenizer(cfg.vocab_size)
    # 1. calibration sample: the query's own rows, prompt-formatted
    rows = workload_rows("correct", 16)
    prompts = [PROMPTS["correct"] + r.text for r in rows]
    toks, lens = tok.pad_batch([tok.encode(p, bos=True) for p in prompts], seq_len=64)
    toks = torch.as_tensor(toks, device=dev)
    opt = InstanceOptimizer(params, cfg)
    opt.run_calibration({"tokens": toks})
    out(f"calibrated on {len(prompts)} rows "
        f"({len(opt.stats.weights)} weight matrices observed)")
    results = []
    # 2. compress
    for recipe in RECIPES:
        p2, c2, rep = opt.apply(recipe)
        # 3. score agreement with the uncompressed baseline
        eval_fn = POL.make_agreement_eval(params, cfg, toks, max_new=8,
                                          lengths=torch.as_tensor(lens, device=dev))
        res = eval_fn(p2, c2)
        out(f"  {rep.summary()}  token-agreement={res.token_agreement:.2f}")
        results.append((rep, res))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = api.init_params(gen, CFG)
    print(f"base model: {CFG.param_count() / 1e6:.2f} M params, "
          f"{param_bytes(params) / 1e6:.2f} MB")
    return compress_and_score(params, CFG, dev)


if __name__ == "__main__":
    main()
