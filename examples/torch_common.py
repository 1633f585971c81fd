"""The examples' shared helpers on the PyTorch port: the trained OLAP model,
the engine factory, the accuracy scorer and the IOLM-DB search.

The port's copies of what ``examples/*.py`` take from
``benchmarks/common.py`` (``MODEL_CFG``, ``load_model``, ``make_engine``,
``task_accuracy``) and ``benchmarks/table1.py`` (``MAX_NEW``,
``optimize_for``), with a ``device`` argument: the card unless the caller
asks for the CPU.  ``load_model`` trains ``tiny-olap`` with the port's
trainer to the reference's recipe into a directory of its own
(``CKPT_DIR``), so the port never serves weights the JAX trainer wrote.
"""
from __future__ import annotations

import os
import sys
from typing import List, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import policy as POL
from repro_torch.core.pipeline import InstanceOptimizer
from repro_torch.kernels.backend import resolve_device
from repro_torch.serving.engine import Engine
from repro_torch.training import checkpoint as CK
from repro_torch.training import data as D
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_loop as TL

CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "results",
                        "torch_tiny_olap_ckpt")

MODEL_CFG = ModelConfig(name="tiny-olap", family="dense", n_layers=4,
                        d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
                        vocab_size=260, rope_theta=10000.0, max_seq=512)

MAX_NEW = {"summarize": 20, "correct": 12, "join": 8}


def load_model(min_steps: int = 300, device="cuda") -> Tuple[ModelConfig, dict,
                                                              D.ByteTokenizer]:
    """The examples' LLM: ``tiny-olap`` trained on the three OLAP tasks
    (300 steps of batch 16, seq 96, AdamW lr 2e-3 with warmup 30), trained
    here when ``CKPT_DIR`` holds fewer than ``min_steps`` steps, else
    restored from it onto ``device``."""
    dev = resolve_device(device)
    tok = D.ByteTokenizer(MODEL_CFG.vocab_size)
    step = CK.latest_step(CKPT_DIR)
    if step is None or step < min_steps:
        steps = max(min_steps, 300)
        out = TL.train(MODEL_CFG,
                       TL.TrainConfig(steps=steps, batch=16, seq_len=96, log_every=100,
                                      ckpt_dir=CKPT_DIR, ckpt_every=300),
                       OPT.adamw(lr=2e-3, warmup=30, total_steps=steps), device=dev)
        return MODEL_CFG, out["params"], tok
    (params, _), _, _ = CK.restore_tree(CKPT_DIR, device=dev)
    return MODEL_CFG, params, tok


def make_engine(params, cfg, tok, **kw) -> Engine:
    kw.setdefault("slots", 8)
    kw.setdefault("max_len", 160)
    kw.setdefault("buckets", (48, 96, 128))
    return Engine(params, cfg, tokenizer=tok, **kw)


def task_accuracy(outs: List[str], rows) -> float:
    return float(np.mean([o.strip().startswith(r.target)
                          for o, r in zip(outs, rows)]))


def optimize_for(task: str, cfg, params, tok, device="cuda"):
    """The IOLM-DB workflow for one workload: calibrate on 16 of its own
    prompts, hold out 8 more, search ``default_recipe_space`` at
    ``acc_floor=0.85``; returns the ``SearchOutcome`` (Perf and Acc with
    their params kept)."""
    dev = resolve_device(device)
    rows = D.workload_rows(task, 24, seed=5)
    prompts = [D.PROMPTS[task] + r.text for r in rows]
    sample = prompts[:16]
    toks, _ = tok.pad_batch([tok.encode(p, bos=True) for p in sample], seq_len=96)
    opt = InstanceOptimizer(params, cfg)
    opt.run_calibration({"tokens": torch.as_tensor(toks, device=dev)})
    hold = prompts[16:24]
    htoks, hlens = tok.pad_batch(
        [tok.encode(p, bos=True) + [tok.SEP] for p in hold], seq_len=96)
    eval_fn = POL.make_agreement_eval(params, cfg, torch.as_tensor(htoks, device=dev),
                                      max_new=MAX_NEW[task],
                                      lengths=torch.as_tensor(hlens, device=dev))
    return POL.search(opt, eval_fn, POL.default_recipe_space(cfg),
                      acc_floor=0.85, keep_params=True)
