"""A 1-D device mesh over the reference bank's K axis, and the tensors
split over it; the port's counterpart of ``jax.sharding.Mesh``,
``PartitionSpec`` and ``NamedSharding`` as the tuning service and the
checkpoint manager use them.

The port is single-controller, as the reference is: one process and one
:class:`~repro_torch.serve.tuning.TuningService` drive every device of
the mesh.  Each K shard of the service's state is a separate contiguous
tensor on its own ``torch.device``, and each shard's kernel is launched
on that device.  A mesh may name one device more than once, the
counterpart of the reference's forced host devices: ``["cpu"] * 8`` on a
host without a card, or ``["cuda:0"] * 4`` on a machine with one card.

The reference's ``sharding/compat.py`` has no counterpart here: it is a
shim over jax's moving ``shard_map`` API, and the port launches one
kernel a shard instead.  Of its ``sharding/rules.py`` the port has
``ExecConfig`` (:mod:`repro_torch.sharding.rules`); the rules that map
model pytrees onto a mesh, and ``launch/mesh.py``, wait for the model
zoo's dry-run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["BankMesh", "make_mesh", "mesh_layout", "canonical_device",
           "PartitionSpec", "NamedSharding", "ShardedTensor",
           "shard_tensor"]

DeviceLike = Union[str, torch.device]


def canonical_device(device: DeviceLike) -> torch.device:
    """``device`` as a ``torch.device`` with its index: ``"cuda"`` is
    ``cuda:<current>`` (``torch.device("cuda") != torch.device("cuda:0")``,
    so two names of one card would otherwise read as two cards).  Raises
    when a CUDA device is named and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh device {dev} requested but torch.cuda.is_available() "
                "is False; name CPU devices to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class BankMesh:
    """Devices laid out along named axes, as ``jax.sharding.Mesh``.

    ``devices`` is a sequence of devices (a 1-D mesh) or a numpy object
    array of them whose ``ndim`` equals ``len(axis_names)``.  The tuning
    service shards its bank axis over a 1-D mesh only; a mesh of more
    axes exists so that it can be refused with the reference's error.
    ``devices`` is kept as a numpy object array, so ``mesh.devices.size``
    reads as the reference's tests read it."""

    def __init__(self, devices, axis_names: Union[str, Sequence[str]]
                 = ("bank",)) -> None:
        names = (axis_names,) if isinstance(axis_names, str) \
            else tuple(axis_names)
        grid = np.asarray(devices, dtype=object) \
            if isinstance(devices, np.ndarray) else None
        flat = list(grid.reshape(-1)) if grid is not None else list(devices)
        if not flat:
            raise ValueError("a mesh needs at least one device")
        arr = np.empty((len(flat),), dtype=object)
        arr[:] = [canonical_device(d) for d in flat]
        arr = arr.reshape(grid.shape if grid is not None else (len(flat),))
        if arr.ndim != len(names):
            raise ValueError(f"{arr.ndim}-D device grid for axes {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated mesh axis name in {names}")
        self.devices = arr
        self.axis_names: Tuple[str, ...] = names

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        """{axis name: devices along it}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_list(self) -> Tuple[torch.device, ...]:
        """The mesh's devices in shard order (row-major)."""
        return tuple(self.devices.reshape(-1))

    @property
    def primary(self) -> torch.device:
        """The first device: where a service keeps what is not sharded
        (the verdicts' bank upload) and gathers what crosses shards."""
        return self.devices.reshape(-1)[0]

    def split(self, t: torch.Tensor, dim: int) -> List[torch.Tensor]:
        """``t`` cut along ``dim`` into ``size`` equal parts, part i a
        separate contiguous tensor on device i (a copy even where the
        device is ``t``'s own: no part is a view of ``t``)."""
        n = self.size
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"split over {n} devices")
        return [p.to(d, memory_format=torch.contiguous_format, copy=True)
                for p, d in zip(t.split(t.shape[dim] // n, dim),
                                self.device_list)]

    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """One copy of ``t`` a device (each its own tensor)."""
        return [t.to(d, memory_format=torch.contiguous_format, copy=True)
                for d in self.device_list]

    def gather(self, parts: Sequence[torch.Tensor], dim: int,
               device: Optional[DeviceLike] = None) -> torch.Tensor:
        """Concatenate ``parts`` along ``dim`` on ``device`` (the primary
        device by default)."""
        dev = self.primary if device is None else canonical_device(device)
        return torch.cat([p.to(dev) for p in parts], dim=dim)

    def __repr__(self) -> str:
        return (f"BankMesh({[str(d) for d in self.device_list]}, "
                f"axis_names={self.axis_names})")


def make_mesh(n: Union[int, Sequence[int]],
              axis: Union[str, Sequence[str]] = "bank",
              devices: Optional[Iterable[DeviceLike]] = None) -> BankMesh:
    """A mesh of ``n`` devices along ``axis`` (``n`` and ``axis`` may be
    tuples, as ``jax.make_mesh``'s shapes and names).

    With no ``devices`` the mesh is ``cuda:0 ... cuda:n-1``; fewer visible
    cards raise, and there is never a CPU fallback.  An explicit
    ``devices`` list of ``n`` entries may repeat a device
    (``["cpu"] * 8``, ``["cuda:0"] * 4``)."""
    shape = (n,) if isinstance(n, int) else tuple(n)
    count = math.prod(shape)
    if count < 1:
        raise ValueError(f"mesh shape {shape} holds no device")
    if devices is None:
        visible = torch.cuda.device_count() \
            if torch.cuda.is_available() else 0
        if visible < count:
            raise RuntimeError(
                f"make_mesh({n}) needs {count} CUDA devices, {visible} "
                "visible; pass devices= to name the mesh's devices")
        devices = [f"cuda:{i}" for i in range(count)]
    flat = list(devices)
    if len(flat) != count:
        raise ValueError(f"mesh shape {shape} needs {count} devices, got "
                         f"{len(flat)}")
    grid = np.empty((count,), dtype=object)
    grid[:] = flat
    return BankMesh(grid.reshape(shape), axis)


def mesh_layout(mesh: Optional[BankMesh]
                ) -> Tuple[int, Optional[str], Optional[torch.device]]:
    """(device count, axis name, primary device) of a bank mesh; (1,
    None, None) without one.  Raises ``ValueError`` unless the mesh is
    1-D, with the reference service's message."""
    if mesh is None:
        return 1, None, None
    if len(mesh.axis_names) != 1:
        raise ValueError("TuningService needs a 1-D mesh (one bank "
                         f"axis); got axes {mesh.axis_names}")
    return mesh.size, mesh.axis_names[0], mesh.primary


class PartitionSpec(tuple):
    """Per tensor dim, the mesh axis it is split along, or None:
    ``PartitionSpec(None, "bank")`` splits dim 1.  ``PartitionSpec()``
    (or all None) replicates."""

    def __new__(cls, *parts: Optional[str]) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a :class:`ShardedTensor` lives: its mesh and spec."""
    mesh: BankMesh
    spec: PartitionSpec

    @property
    def dim(self) -> Optional[int]:
        """The split dim, or None when replicated."""
        named = [i for i, p in enumerate(self.spec) if p is not None]
        return named[0] if named else None


class ShardedTensor:
    """A tensor laid over a mesh: ``shards[i]`` on ``mesh.device_list[i]``
    holds part i along the spec's split dim, or the whole tensor when the
    spec replicates.  :meth:`gather` (or ``np.asarray``) rebuilds it on
    one device."""

    def __init__(self, shards: Sequence[torch.Tensor],
                 sharding: NamedSharding) -> None:
        self.shards: Tuple[torch.Tensor, ...] = tuple(shards)
        self.sharding = sharding

    @property
    def shape(self) -> Tuple[int, ...]:
        dim = self.sharding.dim
        shape = list(self.shards[0].shape)
        if dim is not None:
            shape[dim] = sum(s.shape[dim] for s in self.shards)
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self, device: Optional[DeviceLike] = None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's primary device by
        default)."""
        dim = self.sharding.dim
        if dim is None:
            dev = self.sharding.mesh.primary if device is None \
                else canonical_device(device)
            return self.shards[0].to(dev)
        return self.sharding.mesh.gather(self.shards, dim, device)

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        a = self.gather("cpu").numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"{self.sharding.spec!r} over {self.sharding.mesh!r})")


def shard_tensor(t: torch.Tensor, mesh: BankMesh,
                 spec: Sequence[Optional[str]]) -> ShardedTensor:
    """Lay ``t`` over ``mesh`` by ``spec``: split along the one dim that
    names the mesh's axis (evenly: the dim must divide by the device
    count), or replicated on every device when no dim names it."""
    spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec!r} has more entries than the "
                         f"tensor's {t.dim()} dims")
    axis = mesh_layout(mesh)[1]
    named = [i for i, p in enumerate(spec) if p is not None]
    if any(spec[i] != axis for i in named) or len(named) > 1:
        raise ValueError(f"spec {spec!r}: the 1-D mesh's one axis is "
                         f"{axis!r}, named at most once")
    sharding = NamedSharding(mesh, spec)
    if not named:
        return ShardedTensor(mesh.replicate(t), sharding)
    return ShardedTensor(mesh.split(t, named[0]), sharding)
