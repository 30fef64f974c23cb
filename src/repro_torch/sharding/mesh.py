"""Device meshes and the tensors split over them; the port's counterpart
of ``jax.sharding.Mesh``, ``PartitionSpec`` and ``NamedSharding`` as the
tuning service, the checkpoint manager and the MoE layer use them.

The port is single-controller, as the reference is: one process drives
every device of the mesh.  A mesh may name one device more than once,
the counterpart of the reference's forced host devices: ``["cpu"] * 8``
on a host without a card, or ``["cuda:0"] * 8`` on a machine with one
card.

* A 1-D mesh over the reference bank's K axis serves
  :class:`~repro_torch.serve.tuning.TuningService`: each K shard of its
  state is a separate contiguous tensor on its own ``torch.device``
  (:meth:`BankMesh.split`), and each shard's kernel is launched on that
  device.
* A (``data``, ``model``) mesh, or (``pod``, ``data``, ``model``),
  serves the MoE layer's expert parallelism (``models.moe.moe_apply``):
  :meth:`BankMesh.device_grid` lays the devices out as [data shards,
  model shards] and :meth:`BankMesh.parts` cuts a tensor along one named
  axis or a tuple of them into views, so a dim-0 slice of a stacked
  expert weight copies nothing.  The sharded train step
  (``train.step.make_train_step``) runs each data shard's forward with
  its row of that grid, :meth:`BankMesh.data_row`, as the MoE layers'
  mesh.

The reference's ``sharding/compat.py`` has no counterpart here: it is a
shim over jax's moving ``shard_map`` API, and the port runs one call a
shard instead.  Its ``sharding/rules.py`` is ported as
:mod:`repro_torch.sharding.rules`, and ``launch/mesh.py`` as
:mod:`repro_torch.launch.mesh` (the dry-run's production meshes, over
``meta`` devices).
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
#: A mesh axis name, a tuple of them, or None.
Axes = Union[None, str, Tuple[str, ...]]


def _axis_tuple(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


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
    service shards its bank axis over a 1-D mesh only, and refuses a
    mesh of more axes with the reference's error; the MoE layer maps
    its experts over a mesh of ``data`` and ``model`` axes.
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

    def axis_size(self, axes: Axes) -> int:
        """The devices along ``axes``: one axis name, a tuple of them (the
        product of their sizes) or None (1)."""
        return math.prod(self.shape[a] for a in _axis_tuple(axes))

    def device_grid(self, *groups: Axes) -> np.ndarray:
        """The devices as an array with one dim per group of axes, in
        ``groups``' order: dim i runs over the row-major index of the
        axes of ``groups[i]`` (a name or a tuple of names), so
        ``mesh.device_grid(("data",), "model")[d, m]`` is the device of
        data shard d and model shard m.  An axis no group names is a
        replica axis: the grid takes its index 0."""
        names = [a for g in groups for a in _axis_tuple(g)]
        unknown = [a for a in names if a not in self.axis_names]
        if unknown or len(set(names)) != len(names):
            raise ValueError(f"axis groups {groups} over mesh axes "
                             f"{self.axis_names}")
        grid = self.devices
        for i in reversed(range(grid.ndim)):
            if self.axis_names[i] not in names:
                grid = np.take(grid, 0, axis=i)
        kept = [a for a in self.axis_names if a in names]
        grid = grid.transpose([kept.index(a) for a in names])
        return grid.reshape([self.axis_size(g) for g in groups])

    def data_row(self, d: int, data_axes: Axes = ("data",),
                 model_axis: str = "model") -> "BankMesh":
        """The sub-mesh of data shard ``d``: the axes ``data_axes``, each
        of extent 1, then ``model_axis`` over row d of
        ``device_grid(data_axes, model_axis)`` (no model axis where the
        mesh has none).  A data shard's forward maps its MoE layers over
        it, by ``model`` alone."""
        daxes = _axis_tuple(data_axes)
        if model_axis in self.axis_names:
            row = self.device_grid(daxes, model_axis)[d]
            shape = (1,) * len(daxes) + (row.size,)
            names = daxes + (model_axis,)
        else:
            row = self.device_grid(daxes)[d:d + 1]
            shape, names = (1,) * len(daxes), daxes
        return BankMesh(np.asarray(row, dtype=object).reshape(shape), names)

    def parts(self, t: torch.Tensor, dim: int, axes: Axes
              ) -> List[torch.Tensor]:
        """``t`` cut evenly along ``dim`` into ``axis_size(axes)`` parts,
        part j for the row-major index j over ``axes`` (the order of
        :meth:`device_grid`).  Each part is a view of ``t`` on ``t``'s
        device (contiguous where the cut is along dim 0 of a contiguous
        tensor); the caller moves it where it runs."""
        n = self.axis_size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor does "
                             f"not split over {axes!r} ({n} shards)")
        return list(t.split(t.shape[dim] // n, dim))

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
    """Per tensor dim, the mesh axis it is split along, a tuple of axes
    (split over their devices in row-major order, as ``("pod",
    "data")``), or None: ``PartitionSpec(None, "bank")`` splits dim 1.
    ``PartitionSpec()`` (or all None) replicates."""

    def __new__(cls, *parts: Axes) -> "PartitionSpec":
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
