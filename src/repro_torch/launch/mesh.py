"""Device-group meshes: the counterpart of the reference's
``repro/launch/mesh.py``.

The port's engine is one process that drives every server, as the
reference's single controller is.  A server that is a TP/EP device group
holds a :class:`GroupMesh`: a ``(data, model)`` array of *device slots*,
each a ``torch.device`` on which that slot's shard of the params and the
cache pool lives.  The pooled steps run the per-slot body on every slot
and join them with explicit tensor collectives (``models.layers.GroupCtx``);
there is no ``torch.distributed`` process group and no DTensor here.

An explicit ``devices=`` list may name one physical device several times:
that is how a (2, 4) group runs on the CPU, or on one card.  Without it,
``group_meshes`` takes ``cuda:i`` for ``i < torch.cuda.device_count()`` and
raises when the shapes ask for more.

``make_production_mesh`` gives the reference's production meshes — 16 x
16 over ``(data, model)`` and 2 x 16 x 16 over ``(pod, data, model)`` —
as slots on the meta device, where the dry run (``launch.dryrun``) runs
a step without data.  The reference's ``compat_make_mesh`` (a shim over
``jax.make_mesh``'s API changes) has no counterpart.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class GroupMesh:
    """A ``(data, model)`` (or ``(pod, data, model)``) array of device
    slots with its axis names.

    ``devices`` is a numpy object array of ``torch.device``; slots are
    numbered row-major (slot ``i * n_model + j`` sits at ``(i, j)``).  The
    mesh is hashable — by its axis names and its slot devices in order —
    so it can key step caches."""

    def __init__(self, devices, axis_names=("data", "model")):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {arr.shape} needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def slot_devices(self) -> Tuple[torch.device, ...]:
        """The slots' devices in slot order."""
        return tuple(self.devices.reshape(-1))

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.slot_devices()))

    def __eq__(self, other):
        return isinstance(other, GroupMesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"GroupMesh({dict(zip(self.axis_names, self.devices.shape))}"
                f", {[str(d) for d in self.slot_devices()]})")


def _default_devices():
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def group_meshes(group_shapes: Dict, axis_names=("data", "model"),
                 devices: Optional[Sequence] = None) -> Dict:
    """Carve a device list into per-server meshes.

    ``group_shapes`` maps server id -> mesh shape tuple or None (solo).
    Servers take consecutive slices of ``devices`` in sorted-key order;
    ``None`` takes none.  Returns {server_id: GroupMesh | None} for
    ``GeoServingSystem(device_groups=...)``.  ``devices`` defaults to the
    cards present, and the call raises when the shapes ask for more; an
    explicit list may repeat a device (slots that share it)."""
    devs = list(devices) if devices is not None else _default_devices()
    out, off = {}, 0
    for j in sorted(group_shapes):
        shape = group_shapes[j]
        if shape is None:
            out[j] = None
            continue
        n = int(np.prod(shape))
        if off + n > len(devs):
            raise ValueError(
                f"device groups need {off + n} devices, host has "
                f"{len(devs)} (shapes {group_shapes})")
        arr = np.empty((n,), dtype=object)
        arr[:] = [torch.device(d) for d in devs[off:off + n]]
        out[j] = GroupMesh(arr.reshape(tuple(shape)), axis_names)
        off += n
    return out


def make_production_mesh(*, multi_pod: bool = False) -> GroupMesh:
    """The reference's production mesh — (16, 16) over ``(data, model)``,
    or (2, 16, 16) over ``(pod, data, model)`` with ``multi_pod`` — of
    slots on the meta device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return GroupMesh(np.full(shape, torch.device("meta"), dtype=object),
                     axes)


def make_mesh_for(n_devices: Optional[int] = None, model_parallel: int = 1,
                  devices: Optional[Sequence] = None) -> GroupMesh:
    """A ``(n / model_parallel, model_parallel)`` mesh over the first
    ``n_devices`` of ``devices`` (default: the cards present)."""
    devs = list(devices) if devices is not None else _default_devices()
    n = n_devices or len(devs)
    if n > len(devs) or n % model_parallel:
        raise ValueError(f"{n} devices of {len(devs)} do not make a mesh "
                         f"with model axis {model_parallel}")
    arr = np.empty((n,), dtype=object)
    arr[:] = [torch.device(d) for d in devs[:n]]
    return GroupMesh(arr.reshape(n // model_parallel, model_parallel))


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch (data-parallel) dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
