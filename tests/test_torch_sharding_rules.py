"""The port's sharding rules (``repro_torch.sharding.rules``:
``param_specs``, ``opt_state_specs``, ``batch_specs``,
``logical_batch_axes``) against the reference's ``repro.sharding.rules``
for all ten archs at their published sizes: the reference's parameter
tree from ``jax.eval_shape`` of its ``init``, the port's ``DecoderLM``
on the ``meta`` device, on the (2, 4) and (16, 16) (data, model) meshes
and the (2, 16, 16) (pod, data, model) mesh, under ``ExecConfig()``,
``fsdp=True`` and ``moe_expert_tp=True``.  Both read only
``mesh.shape``, so the meshes are stubs holding that dict.

Every spec is compared exactly.  A stacked segment leaf's reference
spec is held to each of its layers' port specs without its leading
(layer-axis) entry.  jax may write a one-axis tuple ``("data",)`` as
``"data"``: the two are the same split and compare equal here.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as rmodel
from repro.models.config import segments
from repro.sharding import rules as rrules
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.sharding import PartitionSpec
from repro_torch.sharding import rules as trules

MESHES = {"2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "pod-2x16x16": {"pod": 2, "data": 16, "model": 16}}
EXECS = {"default": {}, "fsdp": {"fsdp": True},
         "expert-tp": {"moe_expert_tp": True}}


@dataclasses.dataclass(frozen=True)
class StubMesh:
    """What the rules read of a mesh: its ``shape``."""
    axes: tuple

    @property
    def shape(self) -> dict:
        return dict(self.axes)


def _mesh(name: str) -> StubMesh:
    return StubMesh(tuple(MESHES[name].items()))


def _norm(spec, rank: int) -> tuple:
    """A spec as a tuple of rank entries: None, an axis name, or a tuple
    of two or more names (a one-name tuple is that name)."""
    out = []
    for e in tuple(spec) + (None,) * (rank - len(tuple(spec))):
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    cfg = rconfigs.get(arch)
    return cfg, jax.eval_shape(lambda k: rmodel.init(k, cfg),
                               jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_model(arch: str):
    return tmodel.DecoderLM(tconfigs.get(arch),
                            generator=torch.Generator().manual_seed(0),
                            device="meta")


def _flat(tree, prefix: str, out: dict) -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v
    return out


def _unstacked(ref_tree, cfg) -> dict:
    """{port parameter name: (the reference's leaf spec or shape, stacked)}:
    a segment's leaf goes to each of its layers."""
    out = {name: (v, False) for name, v in _flat(
        {k: v for k, v in ref_tree.items() if k != "segments"}, "",
        {}).items()}
    for seg, tree in zip(segments(cfg), ref_tree["segments"]):
        for ki, kind in enumerate(seg.kinds):
            for path, v in _flat(tree[f"{ki}_{kind}"], "", {}).items():
                for r in range(seg.repeats):
                    layer = seg.start_layer + r * len(seg.kinds) + ki
                    out[f"layers.{layer}.{path}"] = (v, True)
    return out


def _both(arch: str, mesh_name: str, ex_name: str):
    """(reference cfg, its shapes, its param specs, its opt specs, the port
    model, its param specs, its opt specs, mesh, the reference's
    ExecConfig)."""
    cfg, shapes = _ref_shapes(arch)
    mesh = _mesh(mesh_name)
    rex = rrules.ExecConfig(**EXECS[ex_name])
    tex = trules.ExecConfig(**EXECS[ex_name])
    rspecs = rrules.param_specs(shapes, cfg, mesh, rex)
    ropt = rrules.opt_state_specs(shapes, rspecs, mesh, rex)
    model = _port_model(arch)
    tspecs = trules.param_specs(model, tconfigs.get(arch), mesh, tex)
    topt = trules.opt_state_specs(model, tspecs, mesh, tex)
    return cfg, shapes, rspecs, ropt, model, tspecs, topt, mesh, rex


CELLS = [(a, m, e) for a in tconfigs.ARCHS for m in MESHES for e in EXECS]


def _ids(cell) -> str:
    return "-".join(cell)


@pytest.mark.parametrize("arch,mesh_name,ex_name", CELLS,
                         ids=[_ids(c) for c in CELLS])
def test_param_specs_equal_reference(arch, mesh_name, ex_name):
    cfg, shapes, rspecs, _, model, tspecs, _, _, _ = _both(
        arch, mesh_name, ex_name)
    want = _unstacked(rspecs, cfg)
    ref_shapes = _unstacked(shapes, cfg)
    assert set(tspecs) == set(want) == \
        {n for n, _ in model.named_parameters()}
    for name, spec in tspecs.items():
        rspec, stacked = want[name]
        rank = len(ref_shapes[name][0].shape) - stacked
        assert isinstance(spec, PartitionSpec) and len(spec) == rank
        if stacked:
            assert tuple(rspec)[0] is None, (name, rspec)
            rspec = tuple(rspec)[1:]
        assert _norm(spec, rank) == _norm(rspec, rank), (name, spec, rspec)


@pytest.mark.parametrize("arch,mesh_name,ex_name", CELLS,
                         ids=[_ids(c) for c in CELLS])
def test_opt_state_specs_equal_reference(arch, mesh_name, ex_name):
    """The port's moment specs equal the reference's ``opt_state_specs``
    on the unstacked tree (each layer's own shape) and, wherever the
    reference's stacked tree keeps its layer axis whole, its stacked
    specs less that axis."""
    cfg, shapes, rspecs, ropt, _, tspecs, topt, mesh, rex = _both(
        arch, mesh_name, ex_name)
    ref_shapes = _unstacked(shapes, cfg)
    ref_params = _unstacked(rspecs, cfg)
    inner = {n: jax.ShapeDtypeStruct(s.shape[1:] if st else s.shape,
                                     s.dtype)
             for n, (s, st) in ref_shapes.items()}
    inner_specs = {n: jax.sharding.PartitionSpec(
        *(tuple(s)[1:] if st else tuple(s)))
        for n, (s, st) in ref_params.items()}
    want = rrules.opt_state_specs(inner, inner_specs, mesh, rex)
    stacked = _unstacked(ropt, cfg)
    assert set(topt) == set(want)
    for name, spec in topt.items():
        rank = len(inner[name].shape)
        assert _norm(spec, rank) == _norm(want[name], rank), \
            (name, spec, want[name])
        rspec, st = stacked[name]
        if st and tuple(rspec)[0] is None:
            assert _norm(spec, rank) == _norm(tuple(rspec)[1:], rank)
        elif not st:
            assert _norm(spec, rank) == _norm(rspec, rank)


def test_opt_state_specs_without_zero1():
    """``zero1=False``: the moments take the parameters' specs."""
    mesh = _mesh("2x4")
    ex = trules.ExecConfig(zero1=False)
    model = _port_model("minitron-4b")
    specs = trules.param_specs(model, None, mesh, ex)
    assert trules.opt_state_specs(model, specs, mesh, ex) == specs


BATCH_CELLS = [(a, m) for a in tconfigs.ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mesh_name", BATCH_CELLS,
                         ids=["-".join(c) for c in BATCH_CELLS])
def test_batch_specs_equal_reference(arch, mesh_name):
    """Every input-shape suite entry's batch (the reference's
    ``input_specs``: tokens, labels, a decode token and its scalar
    position, qwen2-vl's embeddings and m-rope positions [3, B, S])."""
    mesh = _mesh(mesh_name)
    for shape in tconfigs.SHAPES:
        batch = rconfigs.input_specs(arch, shape)
        want = rrules.batch_specs(batch, mesh)
        got = trules.batch_specs(
            {k: torch.empty(v.shape, device="meta") for k, v in
             batch.items()}, mesh)
        assert set(got) == set(want)
        for k, spec in got.items():
            rank = len(batch[k].shape)
            assert _norm(spec, rank) == _norm(want[k], rank), \
                (arch, shape, k, spec, want[k])


def test_batch_specs_nested_and_shapes():
    """A nested batch keeps its structure; leaves may be anything with a
    shape."""
    mesh = _mesh("pod-2x16x16")
    got = trules.batch_specs({"a": {"positions": np.zeros((3, 64, 8)),
                                    "x": np.zeros((31, 4))},
                              "pos": torch.zeros(())}, mesh)
    assert got == {"a": {"positions": PartitionSpec(None, ("pod", "data"),
                                                    None),
                         "x": PartitionSpec(None, None)},
                   "pos": PartitionSpec()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_batch_axes(mesh_name):
    mesh = _mesh(mesh_name)
    assert trules.logical_batch_axes(mesh) == \
        rrules.logical_batch_axes(mesh)


def test_partition_spec_takes_axis_tuples():
    spec = PartitionSpec(("pod", "data"), None, "model")
    assert tuple(spec) == (("pod", "data"), None, "model")
    assert repr(spec) == "PartitionSpec(('pod', 'data'), None, 'model')"
