"""Production mesh construction — the port of ``repro/launch/mesh.py``.

The reference lays a TPU pod out on forced host devices for its
dry-run.  The port's dry-run (``launch/dryrun.py``) prices a cell from
its sharding specs and reads only the mesh's shape and axis names, so
:func:`make_production_mesh` returns a
:class:`~repro_torch.sharding.mesh.BankMesh` of that shape over
``meta`` devices: it names no card and allocates nothing.
:func:`make_local_mesh` is the mesh of the cards this process sees.
Both are functions, never module-level constants, so importing this
module touches no device.
"""

from __future__ import annotations

import math

import torch

from ..sharding.mesh import BankMesh, make_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> BankMesh:
    """16x16 single pod (256 chips) on ("data", "model"), or 2x16x16 two
    pods (512 chips) on ("pod", "data", "model"), over ``meta`` devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=["meta"] * math.prod(shape))


def make_local_mesh() -> BankMesh:
    """(n, 1) mesh on ("data", "model") over the n visible CUDA cards.
    Raises when there is none: there is no CPU fallback."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_local_mesh: no CUDA device visible "
                           "(torch.cuda.is_available() is False)")
    return make_mesh((n, 1), ("data", "model"))
