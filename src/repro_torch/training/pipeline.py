"""Pipeline parallelism: GPipe-style microbatch pipelining over a
``stage`` mesh axis.

The counterpart of the reference's ``training/pipeline.py``.  The model
is split into S stages of equal layer count; microbatches stream
through the stages.  The GPipe schedule runs S + M - 1 ticks for M
microbatches; at each tick every stage computes its layers on the
microbatch it holds (stage ``s`` on its position's device), then
``ppermute`` moves the activations to the next stage's position.  Bubble
fraction = (S-1)/(S+M-1).  One controller drives every stage, as the
reference's ``shard_map`` over the stage axis does; the result equals
the sequential forward.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import collectives
from repro_torch.tree import tree_map


def _stage_params(params_stacked, s: int, device):
    return tree_map(lambda a: a[s].to(device), params_stacked)


def pipeline_forward(stage_fn: Callable, params_stacked, x_mb: torch.Tensor, *,
                     mesh, axis: str = "stage") -> torch.Tensor:
    """Run M microbatches through S pipeline stages.

    stage_fn(stage_params, x) -> x            (one stage's computation)
    params_stacked: tree with a leading [S] axis (stage ``s``'s slice
      lives on the device of the mesh position with ``axis`` = s)
    x_mb: [M, mb, ...] microbatches
    Returns [M, mb, ...] outputs on the mesh's first device.
    """
    S = mesh.shape[axis]
    M = x_mb.shape[0]
    T = S + M - 1                                 # schedule ticks
    names = mesh.axis_names
    devs = [mesh.devices[tuple(s if a == axis else 0 for a in names)] for s in range(S)]
    stage_p = [_stage_params(params_stacked, s, devs[s]) for s in range(S)]
    bufs = [torch.zeros_like(x_mb[0], device=d) for d in devs]
    outs = torch.zeros_like(x_mb, device=devs[-1])
    for t in range(T):
        # stage 0 ingests microbatch t (if any)
        bufs[0] = (x_mb[t].to(devs[0]) if t < M
                   else torch.zeros_like(x_mb[0], device=devs[0]))
        # every stage computes on what it holds
        ys = [stage_fn(p, b) for p, b in zip(stage_p, bufs)]
        # the last stage retires microbatch t - (S - 1)
        done = t - (S - 1)
        if 0 <= done < M:
            outs[done] = ys[-1]
        # shift activations to the next stage
        bufs = collectives.ppermute(ys, [(i, (i + 1) % S) for i in range(S)])
    return outs.to(mesh.first_device)


def split_stages(layer_params, n_stages: int):
    """Re-stack [L, ...] layer params into [S, L/S, ...] stage params."""
    def re(a):
        L = a.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])
    return tree_map(re, layer_params)


__all__ = ["pipeline_forward", "split_stages"]
