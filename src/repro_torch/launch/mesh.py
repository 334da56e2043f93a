"""Device meshes (counterpart of ``repro.launch.mesh`` and of
``repro.compat.make_mesh``).

A :class:`Mesh` is what the sharding rules read: ``shape``, an ordered
axis -> size map, and ``axis_names``. ``devices`` is ``None`` for an
abstract mesh (the dry-run's production meshes, which no machine here
holds) or an array of ``torch.device`` shaped as the mesh, for a real
one. Building a mesh touches no device state.

The rest of ``repro.compat`` has no counterpart: ``use_mesh``, the
Pallas compiler-params alias and ``shard_map`` are shims over JAX
versions.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

# what is left of running a model across more than one card: ROADMAP.md
# queue 1, item 2's list, each entry what a multi-device path refuses with
MULTI_CARD_ITEM = ("ROADMAP.md queue 1 item 2, running a model across "
                   "more than one card")
MULTI_CARD_LEFT = {
    "data": "the prefix cache, speculation, the gather mode and the "
            "non-dense families over a data axis of more than one device",
    "families": "MoE expert parallelism with its all-to-all; SSM, hybrid "
                "and VLM across cards",
    "train": "training across cards",
    "colocated": "co-located replicas of a model over several cards (each "
                 "replica's collectives on a group of its own)",
}


def multi_card_item(what: str) -> str:
    """The ROADMAP entry a path that is not executed across cards names:
    ``what`` is a key of :data:`MULTI_CARD_LEFT`."""
    n = list(MULTI_CARD_LEFT).index(what) + 1
    return f"{MULTI_CARD_ITEM}, left {n}: {MULTI_CARD_LEFT[what]}"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    shape: "OrderedDict[str, int]"
    devices: Optional[np.ndarray] = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A mesh of ``axis_shapes`` named ``axis_names``: abstract without
    ``devices``, else over those devices in order (their count must be the
    mesh's size)."""
    if len(axis_shapes) != len(axis_names) or \
            len(set(axis_names)) != len(axis_names):
        raise ValueError(f"axis shapes {tuple(axis_shapes)} and names "
                         f"{tuple(axis_names)} do not pair up")
    shape = OrderedDict((str(n), int(s)) for n, s in zip(axis_names,
                                                         axis_shapes))
    if devices is None:
        return Mesh(shape)
    devs = [torch.device(d) for d in devices]
    if len(devs) != math.prod(shape.values()):
        raise ValueError(f"{len(devs)} devices for a mesh of "
                         f"{math.prod(shape.values())}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(shape, arr.reshape(tuple(shape.values())))


def make_model_mesh(devices: Sequence[Union[str, torch.device]]) -> Mesh:
    """A ``1 x M`` mesh (``data`` 1, ``model`` M) over ``devices`` in
    order: tensor parallelism over M devices, e.g. ``cuda:0..M-1``."""
    return make_mesh((1, len(devices)), ("data", "model"), devices)


def make_data_mesh(devices: Sequence[Union[str, torch.device]],
                   data: int) -> Mesh:
    """A ``D x M`` mesh (``data`` D, ``model`` M = ``len(devices) / D``)
    over ``devices`` in order: device ``d * M + m`` is data rank ``d``'s
    model rank ``m``. Each data rank serves its block of the batch rows,
    each over a tensor-parallel group of M devices."""
    if data < 1 or len(devices) % data:
        raise ValueError(f"{len(devices)} devices do not split into a data "
                         f"axis of {data}")
    return make_mesh((data, len(devices) // data), ("data", "model"),
                     devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes, abstract: ``data x model`` of
    16 x 16, or ``pod x data x model`` of 2 x 16 x 16."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_test_mesh(device: Optional[Union[str, torch.device]] = None
                   ) -> Mesh:
    """A 1 x 1 mesh with the production axis names over one device: the
    card unless the caller asks for the CPU."""
    return make_mesh((1, 1), ("data", "model"), [resolve_device(device)])


def mesh_chips(mesh: Mesh) -> int:
    return mesh.size
