"""Device meshes: a grid of ``torch.device``s with named axes.

The counterpart of the reference's ``launch/mesh.py``.  The reference is
single-controller: one process drives every device of a
``jax.sharding.Mesh``.  The port is too: a :class:`Mesh` is a numpy grid
holding one ``torch.device`` per position, and the sharded code
(``core/compressed.py`` ``ShardedTensor``, ``distributed/collectives.py``)
computes each position's piece on that position's device from one
Python thread.  Positions may share a device: on a host with one card
every position of a ``(1, 4)`` mesh is ``cuda:0``, and the sharded
arithmetic runs there piece by piece; on a host with four cards they are
``cuda:0..3``.  The code is the same either way.

A mesh carries what the reference's code reads of a jax mesh:
``.devices`` (the grid), ``.axis_names`` and ``.shape`` (axis name ->
size).  The production meshes (single pod ``(16, 16)``, multi-pod
``(2, 16, 16)``) are shape-only: their positions are on the ``meta``
device, for the dry run (``launch/dryrun.py``), which touches no card.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


class Mesh:
    """A grid of devices with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """Where a sharded step's gathered results, the slot state's
        unsharded leaves (recurrent state), norms and sampling live."""
        return self.devices.flat[0]

    def coords(self, i: int) -> Dict[str, int]:
        """Axis name -> coordinate of flat position ``i`` (row-major, as
        ``devices.flat``)."""
        return dict(zip(self.axis_names, np.unravel_index(i, self.devices.shape)))

    def tag(self) -> str:
        """The mesh's shape and devices, e.g. ``mesh1x4:cuda:0,cuda:0,...``."""
        return ("mesh" + "x".join(str(s) for s in self.devices.shape) + ":"
                + ",".join(str(d) for d in self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, devices=None,
              device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes``: one position per listed device
    (``devices``, row-major), or every position on ``device``.  Asking for
    ``"cuda"`` without a card raises, as every entry point of the port
    does."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if devices is None:
        dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        devices = [dev] * n
    else:
        devices = [torch.device(d) if str(d) == "meta" else resolve_device(d)
                   for d in devices]
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for a mesh of {n} positions")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = d
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod ``(data=16, model=16)`` or multi-pod ``(pod=2, data=16,
    model=16)``, shape-only (positions on ``meta``): the dry run's meshes."""
    shape: Tuple[int, ...] = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device="meta")


def make_host_mesh(shape=(2, 2), axes=("data", "model"), *, device="cuda") -> Mesh:
    """A small mesh with every position on ``device`` (the card unless
    the caller asks for the CPU, as tests do): single-pod ``(data,
    model)``, or multi-pod at a small size, e.g. ``(2, 2, 1)`` over
    ``("pod", "data", "model")``."""
    return make_mesh(shape, axes, device=device)


__all__ = ["Mesh", "make_host_mesh", "make_mesh", "make_production_mesh"]
