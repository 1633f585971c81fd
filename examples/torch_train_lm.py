"""Train an LM on the OLAP-task mixture with the PyTorch port, with
checkpoint/restart.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --steps 60 --device cpu

Kill it mid-run and re-invoke: it resumes from the last atomic
checkpoint (the fault-tolerance drill).  ``examples/train_lm.py`` on the
port; its checkpoints are the port's, in a directory of their own.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs.base import ModelConfig
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_loop as TL


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=96)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default="results/torch_train_lm_ckpt")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="train-lm", family="dense",
                      n_layers=args.layers, d_model=args.dim,
                      n_heads=max(4, args.dim // 64),
                      n_kv_heads=max(2, args.dim // 128),
                      d_ff=args.dim * 3, vocab_size=260, max_seq=1024)
    print(f"model: {cfg.param_count() / 1e6:.1f} M params")
    tcfg = TL.TrainConfig(steps=args.steps, batch=args.batch, seq_len=args.seq,
                          microbatches=args.microbatches,
                          ckpt_dir=args.ckpt, ckpt_every=100, log_every=20)
    out = TL.train(cfg, tcfg, OPT.adamw(lr=2e-3, warmup=30, total_steps=args.steps),
                   device=args.device)
    print(f"done; final loss {out['losses'][-1][1]:.4f}; "
          f"checkpoints in {args.ckpt}")
    return out


if __name__ == "__main__":
    main()
