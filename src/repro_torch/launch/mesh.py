"""Mesh construction (port of ``repro/launch/mesh.py``).

Functions, never module-level constants: importing this module touches
no device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import Mesh


def _local_devices() -> list:
    """Every local card, in index order (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``; raises when there are too
    few cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    devices = _local_devices()[:n]
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {len(devices)}; "
            "build a smaller one with make_local_mesh")
    return Mesh(np.asarray(devices, dtype=object).reshape(shape), axes)


def make_local_mesh(shape=(1, 1), axes=("data", "model"),
                    devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (None: the local cards),
    taken in order; a list of one device repeats it over the whole mesh,
    which is how one card (or the CPU, ``devices=["cpu"]``) stands for
    every shard.  Raises when there are too few devices."""
    n = int(np.prod(shape))
    devices = _local_devices() if devices is None else list(devices)
    if len(devices) == 1:
        devices = devices * n
    if len(devices) < n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} devices, have "
                           f"{len(devices)}")
    flat = np.empty(n, dtype=object)
    flat[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(flat.reshape(tuple(shape)), axes)
