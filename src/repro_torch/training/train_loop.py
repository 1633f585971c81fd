"""Training loop: microbatch accumulation, remat, checkpoint/restart.

The reference's trainer (``training/train_loop.py``) on PyTorch:

  - deterministic (seed, step) -> batch (``training/data.py``), so a
    killed trainer replays the same batches;
  - atomic checkpoints every ``ckpt_every`` steps and at the end
    (``training/checkpoint.py``, the reference's on-disk format); on
    start the loop resumes from the latest one;
  - gradient accumulation over ``microbatches`` in f32, divided by M,
    keeps the activation footprint at 1/M;
  - an optional ``grad_compressor`` hook ``(grads, residual) -> (grads,
    residual)`` between the gradients and the update: the int8
    error-feedback all-reduce over a mesh axis is
    ``functools.partial(grad_compress.compressed_allreduce, axis=...,
    mesh=...)`` (``training/grad_compress.py``);
  - a sharded param tree trains as it is: ``params=`` placed by
    ``sharding.place(params, sharding.param_shardings(cfg, params, mesh,
    fsdp=...))`` trains data-parallel where the mesh's dp axes split the
    batch (:func:`make_train_step`), with gradients cut as the params
    are, an optimizer state placed as the reference's
    ``opt_state_shardings`` says (``Optimizer.init``), and a checkpoint
    restored onto the params' own layout.  Like the reference's
    ``train``, it takes no mesh: the params carry it.

Params come from a seeded ``torch.Generator`` on ``device`` (default
``"cuda"``, which raises without a card), or from ``params=``; a placed
tree's whole leaves and the batch live on ``device``, its mesh's first.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.compressed import ShardedTensor
from repro_torch.distributed.data_parallel import (dp_split, mesh_of, mesh_step,
                                                   split_value_and_grad)
from repro_torch.distributed.sharding import shardings_of
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import api
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data as D
from repro_torch.training.optimizer import Optimizer, global_norm
from repro_torch.tree import tree_map, value_and_grad


@dataclass
class TrainConfig:
    steps: int = 200
    batch: int = 16
    seq_len: int = 128
    microbatches: int = 1
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    log_every: int = 20
    xent_chunk: int = 0
    aux_weight: float = 0.01


def _leafwise(fn):
    """``fn`` over matching leaves, piece by piece where they are sharded."""
    def one(a, *rest):
        return a.map(fn, *rest) if isinstance(a, ShardedTensor) else fn(a, *rest)
    return one


def make_train_step(model_cfg, optimizer: Optimizer, *,
                    microbatches: int = 1, xent_chunk: int = 0,
                    grad_compressor: Optional[Callable] = None,
                    aux_weight: float = 0.01, remat: bool = True):
    """(params, opt_state, batch, step[, residual]) -> updated state.

    ``batch["tokens"/"labels"]``: [B, S] tensors; B must divide by
    ``microbatches``.  Metrics are device scalars ``loss`` and
    ``grad_norm`` (the norm before clipping).  The update is written
    into the given params and state (``Optimizer.update``).

    On a placed tree (``sharding.place``) the step is the reference's
    SPMD step on the params' mesh: where ``sharding.batch_shardings``
    splits the batch's rows over the mesh's dp axes (``("pod", "data")``
    on a multi-pod mesh, ``("data",)`` otherwise: B divisible by their
    size), each dp position runs the forward and backward of its rows,
    FSDP weights are gathered where they are used, and every gradient is
    reduced over the dp axes through ``collectives`` once a step
    (``distributed/data_parallel.py`` ``split_value_and_grad``):
    microbatches split the global rows first and the dp axes second, and
    each position accumulates over its microbatches before the reduction.
    Where the spec leaves the batch whole, the step runs it whole and
    reduces nothing over the dp axes, as the reference does; a batch
    that splits but whose microbatches do not raises.  Either way the
    model axis's collectives and their backward conjugates go through
    ``collectives`` and are counted (``launch/roofline.py``
    ``train_collectives``); the scalar loss's sum over the positions is
    counted too, the gradient norm's sums are not."""
    def loss(p, b):
        return api.loss_fn(p, model_cfg, b, xent_chunk=xent_chunk, remat=remat,
                           aux_weight=aux_weight)

    def whole_value_and_grad(params, batch):
        if microbatches == 1:
            return value_and_grad(lambda p: loss(p, batch), params)
        M = microbatches
        B = batch["tokens"].shape[0]
        if B % M:
            raise ValueError(f"batch {B} does not divide into {M} microbatches")
        lv = None
        grads = None
        for i in range(M):
            mb = {k: v[i * (B // M):(i + 1) * (B // M)] for k, v in batch.items()}
            li, gi = value_and_grad(lambda p: loss(p, mb), params)
            if grads is None:
                lv, grads = li.float(), tree_map(_leafwise(lambda g: g.float()), gi)
            else:
                lv = lv + li
                grads = tree_map(_leafwise(lambda a, g: a.add_(g)), grads, gi)
            del gi
        return lv / M, tree_map(_leafwise(lambda g: g.div_(M)), grads)

    def train_step(params, opt_state, batch, step, residual=None):
        mesh = mesh_of(params)
        if mesh is None:
            lv, grads = whole_value_and_grad(params, batch)
        elif dp_split(mesh, batch["tokens"].shape[0]):
            lv, grads = split_value_and_grad(loss, params, batch, mesh,
                                             microbatches=microbatches,
                                             lockstep=model_cfg.family == "moe")
        else:
            with mesh_step():
                lv, grads = whole_value_and_grad(params, batch)
        if grad_compressor is not None:
            grads, residual = grad_compressor(grads, residual)
        gnorm = global_norm(grads)
        params, opt_state = optimizer.update(params, grads, opt_state, step)
        metrics = {"loss": lv, "grad_norm": gnorm}
        if grad_compressor is not None:
            return params, opt_state, residual, metrics
        return params, opt_state, metrics

    return train_step


def train(model_cfg, tcfg: TrainConfig, optimizer: Optimizer, *,
          params=None, log: Callable[[str], None] = print,
          batch_fn: Optional[Callable] = None, device="cuda") -> Dict[str, Any]:
    """End-to-end training with restart support, on one device or, for a
    placed ``params=`` tree, on its mesh."""
    dev = resolve_device(device)
    tok = D.ByteTokenizer(max(model_cfg.vocab_size, 260))
    if batch_fn is None:
        def batch_fn(step):
            return D.train_batch(step, batch=tcfg.batch, seq_len=tcfg.seq_len,
                                 tok=tok, seed=tcfg.seed)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(tcfg.seed)
        params = api.init_params(gen, model_cfg)
    opt_state = optimizer.init(params)
    start = 0
    if tcfg.ckpt_dir and ckpt.latest_step(tcfg.ckpt_dir) is not None:
        target = (params, opt_state)
        (params, opt_state), start, _ = ckpt.restore(tcfg.ckpt_dir, target, device=dev,
                                                     shardings=shardings_of(target))
        log(f"[train] resumed from step {start}")

    step_fn = make_train_step(model_cfg, optimizer, microbatches=tcfg.microbatches,
                              xent_chunk=tcfg.xent_chunk, aux_weight=tcfg.aux_weight)
    losses = []
    t0 = time.time()
    for step in range(start, tcfg.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_fn(step).items()
                 if k in ("tokens", "labels")}
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            lv = float(metrics["loss"])
            losses.append((step, lv))
            log(f"[train] step {step:5d} loss {lv:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({(time.time() - t0):.1f}s)")
        if tcfg.ckpt_dir and tcfg.ckpt_every \
                and (step + 1) % tcfg.ckpt_every == 0:
            ckpt.save(tcfg.ckpt_dir, step + 1, (params, opt_state))
    if tcfg.ckpt_dir:
        ckpt.save(tcfg.ckpt_dir, tcfg.steps, (params, opt_state))
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "tokenizer": tok}


__all__ = ["TrainConfig", "make_train_step", "train"]
