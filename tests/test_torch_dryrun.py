"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.mesh``,
``configs.input_specs``) against the reference's, and the meta
backwards of K9, K10 and the sLSTM scan that its train cells walk.

* ``input_specs``: the reference's keys, shapes and dtypes for every
  cell, the skipped ones included;
* ``n_params``, ``n_active_params`` and ``model_flops_global``: the
  reference's exactly for every cell (its tree from ``jax.eval_shape``,
  as its dry-run takes it);
* per-chip ``argument_size_in_bytes``: a byte count taken from the
  reference's own ``param_specs`` / ``opt_state_specs`` /
  ``cache_specs`` / ``batch_specs`` on stub meshes of 16 x 16 and 2 x 16
  x 16, for every cell.  The port holds each layer's tensors apart, so
  AdamW's moments are counted under the reference's ``opt_state_specs``
  of each layer's own shape (``sharding/rules.py``'s docstring): on a
  stacked leaf the reference's ZeRO-1 may shard the layer axis instead,
  which the port's tensors do not have;
* per-chip flops on a 1 x 1 mesh against the reference's
  ``parse_module`` flops of the same SMOKE step compiled on one CPU
  device, within FLOPS_REL;
* chips x per-chip flops >= the walk's global flops for every cell, at
  full width with the depth cut to one period of the layer pattern (the
  property is op by op, so depth does not change it);
* a walked train step's K9_bwd, K10_bwd and sLSTM_bwd ops, one for each
  forward call its backward reaches, and gradients at every input of
  those calls;
* ``run_cell("granite-20b", "decode_32k")`` end to end, under tmp_path.
"""

import _torch_threads  # noqa: F401  (an xdist worker's share of the threads)
import dataclasses
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.hlocost import parse_module
from repro.models import model as rmodel
from repro.models.config import segments
from repro.sharding import rules as rrules
from repro.train import optim as ropt
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.core.signatures import OpWalker
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.gla.ops import gla_scan
from repro_torch.kernels.slstm.kernel import slstm_scan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import model as tmodel
from repro_torch.sharding.mesh import make_mesh
from repro_torch.sharding.rules import ExecConfig

#: Per-chip flops of a SMOKE step on a 1 x 1 mesh against the reference's
#: HLO flops of the same step.  The two count different programs: the
#: port's K9 computes the causal half of the scores (``causal_pairs``),
#: where the reference's jnp attention computes all S x T and masks; the
#: walk prices each aten op by its table, XLA's fusions count their
#: elementwise work once more or less (a fused select, a broadcast).
#: Measured: 0.94-0.96 on these cells; 10% is the bound asked of them.
FLOPS_REL = 0.10
SMOKE_CELLS = [(a, k) for a in ("minitron-4b", "granite-20b")
               for k in ("train", "prefill")]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@dataclasses.dataclass(frozen=True)
class StubMesh:
    """What the reference's rules read of a mesh: its ``shape``."""
    axes: tuple

    @property
    def shape(self) -> dict:
        return dict(self.axes)


def _ref_dryrun():
    """The reference's ``launch.dryrun``, which sets ``XLA_FLAGS`` to 512
    host devices when imported: jax's backend is brought up first and
    the flag put back, so this process keeps its one device."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as rdry
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return rdry


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    cfg = rconfigs.get(arch)
    return jax.eval_shape(lambda k: rmodel.init(k, cfg),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_model(arch: str):
    return tmodel.DecoderLM(tconfigs.get(arch),
                            generator=torch.Generator().manual_seed(0),
                            device="meta")


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


CELLS = tconfigs.cells(include_skipped=True)


@pytest.mark.parametrize("arch,shape,skip", CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in CELLS])
def test_input_specs_equal_reference(arch, shape, skip):
    want = rconfigs.input_specs(arch, shape)
    got = tconfigs.input_specs(arch, shape)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.is_meta
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert _dtype_name(v.dtype) == _dtype_name(want[k].dtype), k


def _count(spec, mesh) -> int:
    n = 1
    for e in tuple(spec):
        if e is None:
            continue
        for a in ((e,) if isinstance(e, str) else e):
            n *= mesh.shape[a]
    return n


def _ref_argument_bytes(arch: str, shape: str, mesh) -> int:
    """The reference dry-run's argument leaves, each over its spec's
    shard count: parameters, AdamW's count and moments and the batch of
    a train cell; parameters, the cache and the inputs of a serving
    cell."""
    ex = rconfigs.exec_default(arch, shape)
    cfg = rconfigs.get(arch)
    spec = rconfigs.SHAPES[shape]
    params = _ref_params(arch)
    pspecs = rrules.param_specs(params, cfg, mesh, ex)
    leaves = [(params, pspecs)]
    io = rconfigs.input_specs(arch, shape)
    leaves.append((io, rrules.batch_specs(io, mesh)))
    if spec.kind == "train":
        opt = jax.eval_shape(lambda p: ropt.adamw_init(
            p, ropt.AdamWConfig(moment_dtype=ex.optim_dtype)), params)
        inner, inner_specs = _unstacked(params, pspecs, cfg)
        mdt = jax.tree.leaves(opt.m)[0].dtype
        inner = {n: jax.ShapeDtypeStruct(x.shape, mdt)
                 for n, x in inner.items()}
        ospecs = rrules.opt_state_specs(inner, inner_specs, mesh, ex)
        leaves += [(inner, ospecs), (inner, ospecs),
                   (opt.count, jax.sharding.PartitionSpec())]
    else:
        cache = jax.eval_shape(lambda: rmodel.make_cache(
            cfg, spec.global_batch, spec.seq_len))
        leaves.append((cache, rrules.cache_specs(
            cache, cfg, mesh, spec.global_batch)))
    total = 0
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    for tree, specs in leaves:
        for x, s in zip(jax.tree.leaves(tree),
                        jax.tree.leaves(specs, is_leaf=is_spec)):
            nbytes = math.prod(x.shape) * np.dtype(x.dtype).itemsize
            total += nbytes // _count(s, mesh)
    return total


def _unstacked(params, pspecs, cfg):
    """The reference's parameter leaves and specs with each segment's
    stacked leaf cut into its layers (the leading layer axis and its
    spec entry, None, dropped): {index: ShapeDtypeStruct}, {index:
    PartitionSpec}."""
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    shapes, specs = {}, {}

    def add(x, sp, stacked, repeats):
        for _ in range(repeats):
            n = str(len(shapes))
            shapes[n] = jax.ShapeDtypeStruct(
                x.shape[1:] if stacked else x.shape, x.dtype)
            specs[n] = jax.sharding.PartitionSpec(
                *(tuple(sp)[1:] if stacked else tuple(sp)))

    rest = {k: v for k, v in params.items() if k != "segments"}
    rest_specs = {k: v for k, v in pspecs.items() if k != "segments"}
    for x, sp in zip(jax.tree.leaves(rest),
                     jax.tree.leaves(rest_specs, is_leaf=is_spec)):
        add(x, sp, False, 1)
    for seg, tree, stree in zip(segments(cfg), params["segments"],
                                pspecs["segments"]):
        for x, sp in zip(jax.tree.leaves(tree),
                         jax.tree.leaves(stree, is_leaf=is_spec)):
            assert x.shape[0] == seg.repeats and tuple(sp)[0] is None
            add(x, sp, True, seg.repeats)
    return shapes, specs


ARG_CELLS = [(a, s, m) for a, s, _ in CELLS for m in MESHES]


@pytest.mark.parametrize("arch,shape,mesh_name", ARG_CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in ARG_CELLS])
def test_cell_counts_equal_reference(arch, shape, mesh_name):
    """n_params, n_active_params, model_flops_global and the per-chip
    argument bytes of every cell, built (not walked) on each mesh."""
    rdry = _ref_dryrun()
    mesh = make_production_mesh(multi_pod=mesh_name == "2x16x16")
    fn, args, meta, walker = dryrun.build_cell(arch, shape, mesh,
                                               model=_port_model(arch))
    params = _ref_params(arch)
    cfg = rconfigs.get(arch)
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    ref_meta = {"shape": shape, "n_params": n, "mesh": MESHES[mesh_name]}
    if cfg.is_moe:
        ref_meta["n_active_params"] = rdry._active_params_abstract(params,
                                                                   cfg)
    assert meta["n_params"] == n
    assert meta.get("n_active_params") == ref_meta.get("n_active_params")
    kind = rconfigs.SHAPES[shape].kind
    want = rdry.roofline(ref_meta, {}, {}, kind)
    got = dryrun.roofline(meta, walker, {}, kind)
    assert got["model_flops_global"] == want["model_flops_global"]
    assert got["chips"] == want["chips"] == mesh.size
    stub = StubMesh(tuple(MESHES[mesh_name].items()))
    assert walker.argument_bytes() == _ref_argument_bytes(arch, shape, stub)


def _ref_smoke_flops(arch: str, b: int, s: int, kind: str) -> float:
    cfg = rconfigs.smoke_config(arch)
    params = jax.eval_shape(lambda k: rmodel.init(k, cfg),
                            jax.random.PRNGKey(0))
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    if kind == "train":
        ocfg = ropt.AdamWConfig()
        opt = jax.eval_shape(lambda p: ropt.adamw_init(p, ocfg), params)
        step = ref_make_train_step(cfg, rrules.ExecConfig(), ocfg)
        lowered = jax.jit(step).lower(params, opt,
                                      {"tokens": tok, "labels": tok})
    else:
        cache = jax.eval_shape(lambda: rmodel.make_cache(cfg, b, s))
        lowered = jax.jit(lambda p, t, c: rmodel.prefill(p, t, c, cfg)
                          ).lower(params, tok, cache)
    return parse_module(lowered.compile().as_text()).flops


def _local_meta_mesh():
    return make_mesh((1, 1), ("data", "model"), devices=["meta"])


@pytest.mark.parametrize("arch,kind", SMOKE_CELLS,
                         ids=[f"{a}-{k}" for a, k in SMOKE_CELLS])
def test_smoke_flops_near_reference_hlo(arch, kind):
    b, s = 2, 64
    cfg = tconfigs.smoke_config(arch)
    spec = tconfigs.ShapeSpec(f"smoke_{kind}", s, b, kind)
    fn, args, meta, walker = dryrun.build_cell(
        arch, spec, _local_meta_mesh(), ExecConfig(), cfg=cfg)
    rec = dryrun.walk_cell(fn, args, meta, walker, ExecConfig())
    got = rec["roofline"]["per_chip"]["flops"]
    assert got == rec["roofline"]["walk_flops_global"]     # one chip
    want = _ref_smoke_flops(arch, b, s, kind)
    assert abs(got / want - 1) <= FLOPS_REL, (got, want)


def _one_period(cfg):
    """``cfg`` cut to the fewest layers holding each of its block kinds."""
    layers = cfg.first_dense_layers + 1 if cfg.is_moe \
        else len(cfg.block_pattern)
    return dataclasses.replace(cfg, num_layers=layers)


WALK_CELLS = [(a, s) for a, s, _ in tconfigs.cells()]


@pytest.mark.parametrize("arch,shape", WALK_CELLS,
                         ids=[f"{a}-{s}" for a, s in WALK_CELLS])
def test_chips_times_per_chip_covers_the_walk(arch, shape):
    mesh = make_production_mesh()
    ex = tconfigs.exec_default(arch, shape)
    cfg = _one_period(tconfigs.get(arch))
    fn, args, meta, walker = dryrun.build_cell(arch, shape, mesh, ex,
                                               cfg=cfg)
    rec = dryrun.walk_cell(fn, args, meta, walker, ex)
    rf = rec["roofline"]
    assert rf["per_chip"]["flops"] > 0
    assert rf["chips"] * rf["per_chip"]["flops"] >= rf["walk_flops_global"]
    assert all(t >= 0 for t in rf["terms_seconds"].values())
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0


class _CallWalker(OpWalker):
    """An OpWalker that keeps each kernel call's (name, inputs,
    outputs)."""

    def __init__(self) -> None:
        super().__init__()
        self.calls = []

    def _kernel(self, name, flops, nbytes, inputs=(), outputs=()):
        super()._kernel(name, flops, nbytes, inputs, outputs)
        self.calls.append((name, inputs, outputs))


def _walk_loss(arch: str, remat: str, b: int = 1, s: int = 128):
    """loss_fn of ``arch``'s SMOKE config on meta and its gradients at
    every parameter, under a walker that keeps every kernel call.  ->
    (walker, {name: grad})."""
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), remat=remat)
    model = tmodel.DecoderLM(cfg, generator=torch.Generator().manual_seed(0),
                             device="meta")
    tok = torch.empty((b, s), dtype=torch.int32, device="meta")
    walker = _CallWalker()
    with walker:
        model.requires_grad_(True)
        loss, _ = tmodel.loss_fn(model, {"tokens": tok, "labels": tok}, cfg)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(
            loss, [model.get_parameter(n) for n in names], allow_unused=True)
    return walker, dict(zip(names, grads))


BWD_ARCHS = [("minitron-4b", "K9", ("attn.wq", "attn.wk", "attn.wv")),
             ("zamba2-7b", "K10", ("mix.in_proj",)),
             ("xlstm-1p3b", "sLSTM", ("layers.7.mix.w_in", "layers.7.mix.r"))]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch,kernel,reached", BWD_ARCHS,
                         ids=[a for a, _, _ in BWD_ARCHS])
def test_walked_backward_reaches_each_kernel(arch, kernel, reached, remat):
    """Each forward call of ``kernel`` the backward reaches has one
    ``<kernel>_bwd`` op (remat "full" runs the forward twice: the
    recompute), whose gradients have its inputs' shapes, and the
    parameters feeding the kernel get gradients."""
    walker, grads = _walk_loss(arch, remat)
    fwd = walker.kernels[kernel]
    bwd = walker.kernels[f"{kernel}_bwd"]
    assert fwd == (2 if remat == "full" else 1) * bwd > 0
    for name, ins, outs in walker.calls:
        if name == f"{kernel}_bwd":
            n = len(outs)
            assert [o.shape for o in outs] == [i.shape for i in ins[:n]]
            assert all(o.is_meta for o in outs)
    hit = [n for n in grads if any(r in n for r in reached)]
    assert hit and all(grads[n] is not None for n in hit), hit


def test_meta_backwards_one_op_each():
    """Each wrapper on meta tensors that require grad: the output comes
    through its autograd.Function, and backward reports one op and
    gives every input a meta gradient of its shape."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta",
                           requires_grad=True)
    cases = [
        ("K9", lambda: (meta(1, 4, 128, 64), meta(1, 2, 128, 64),
                        meta(1, 2, 128, 32)),
         lambda q, k, v: flash_attention(q, k, v, device="meta")),
        ("K10", lambda: (meta(1, 2, 256, 64), meta(1, 2, 256, 64),
                         meta(1, 2, 256, 32), meta(1, 2, 256)),
         lambda q, k, v, la: gla_scan(q, k, v, la, chunk=128,
                                      device="meta")[0]),
        ("sLSTM", lambda: (meta(2, 16, 4 * 32), meta(4, 32)) + tuple(
            meta(2, 32) for _ in range(4)),
         lambda z, r, h, c, n, m: slstm_scan(z, r, h, c, n, m)[0]),
    ]
    for name, make, call in cases:
        ins = make()
        walker = OpWalker()
        with walker:
            out = call(*ins)
            assert out.grad_fn is not None, name
            out.sum().backward()
        assert walker.kernels == {name: 1, f"{name}_bwd": 1}, name
        for t in ins:
            assert t.grad is not None and t.grad.is_meta \
                and t.grad.shape == t.shape, name


def test_meta_k9_backward_priced_by_its_bound():
    """K9_bwd: 2 (3 dh + 2 dv) flops a causal pair; q, k, v, o, do, lse
    read and dq, dk, dv written once."""
    b, h, kv, s, dh, dv = 1, 4, 2, 128, 64, 32
    q = torch.empty((b, h, s, dh), device="meta", requires_grad=True)
    k = torch.empty((b, kv, s, dh), device="meta", requires_grad=True)
    v = torch.empty((b, kv, s, dv), device="meta", requires_grad=True)
    walker = OpWalker()
    with walker:
        flash_attention(q, k, v, device="meta").sum().backward()
    cost = next(c for c in walker.costs if c.name == "K9_bwd")
    pairs = s * (s + 1) // 2
    assert cost.flops == 2 * (3 * dh + 2 * dv) * b * h * pairs
    assert cost.bytes == 4 * (2 * b * h * s * (dh + dv)
                              + 2 * b * kv * s * (dh + dv) + b * h * s)


def test_bf16_train_cell_prices_k9_backward_at_the_bf16_rate():
    """A bf16 train cell's K9_bwd ops take K9 bf16's backward rate, the
    bf16 tensor-core peak over the 2 bf16 products a product it issues
    at dh = dv = 128, and a float32 cell's the split-TF32 rate:
    minitron-4b cut to 2 layers, on 1 x 4096 tokens."""
    spec = tconfigs.ShapeSpec("train_4k", 4096, 1, "train")
    ex = tconfigs.exec_default("minitron-4b", "train_4k")
    peaks = {}
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(tconfigs.get("minitron-4b"), num_layers=2,
                                  param_dtype=dt, dtype=dt)
        fn, args, meta, walker = dryrun.build_cell(
            "minitron-4b", spec, _local_meta_mesh(), ex, cfg=cfg)
        dryrun.walk_cell(fn, args, meta, walker, ex)
        peaks[dt] = {p for c, p in zip(walker.costs, walker._peaks)
                     if c.name == "K9_bwd"}
    assert peaks["bfloat16"] == {dryrun.PEAKS["bf16"] / 2}
    assert peaks["float32"] == {dryrun.PEAKS["tf32"] / 3}


@pytest.mark.parametrize("dh,dv,issued", [
    (64, 64, 6 * 64 + 4 * 64), (96, 96, 6 * 128 + 4 * 128),
    (112, 112, 6 * 128 + 4 * 128), (128, 128, 6 * 128 + 4 * 128),
    (192, 128, 6 * 192 + 4 * 128)])
def test_bf16_k9_backward_rate_follows_the_kernels_widths(dh, dv, issued):
    """K9 bf16's backward on meta is priced at the bf16 peak over the
    products its kernels issue at their instantiation (64, 128, or MLA's
    192 x 128: 6 DK + 4 DV a causal pair, no zero chunk at MLA's head) a
    product of the least work, 3 dh + 2 dv; float32 inputs keep split
    TF32's rate."""
    q, k, o, do = (torch.empty((1, 2, 64, d), device="meta",
                               dtype=torch.bfloat16)
                   for d in (dh, dh, dv, dv))
    v = torch.empty((1, 2, 64, dv), device="meta", dtype=torch.bfloat16)
    lse = torch.empty((1, 2, 64), device="meta")
    ins = (q, k, v, o, do, lse)
    assert dryrun.op_peak("K9_bwd", torch.bfloat16, ins) == pytest.approx(
        dryrun.PEAKS["bf16"] * (3 * dh + 2 * dv) / issued, rel=1e-12)
    assert dryrun.op_peak("K9_bwd", torch.float32, ins) == \
        dryrun.PEAKS["tf32"] / 3


@pytest.mark.parametrize("microbatch,b,fwd,bwd", [(1, 1, 16, 8),
                                                  (2, 2, 32, 16)])
def test_minitron_cut_walk_counts(microbatch, b, fwd, bwd):
    """The walk ``chip_smoke.py`` phase 28 holds to phase 27's launch
    counts: minitron-4b, 8 of 32 layers, float32, its train_4k exec
    (remat "full"), on b x 4096 tokens: K9 f32 two forwards and one
    backward a layer a microbatch."""
    ex = dataclasses.replace(tconfigs.exec_default("minitron-4b",
                                                   "train_4k"),
                             microbatch=microbatch)
    cfg = dataclasses.replace(tconfigs.get("minitron-4b"), num_layers=8,
                              param_dtype="float32", dtype="float32")
    spec = tconfigs.ShapeSpec("train_4k", 4096, b, "train")
    fn, args, meta, walker = dryrun.build_cell(
        "minitron-4b", spec, _local_meta_mesh(), ex, cfg=cfg)
    rec = dryrun.walk_cell(fn, args, meta, walker, ex)
    assert rec["walk"]["kernels"] == {"K9": fwd, "K9_bwd": bwd}
    assert rec["roofline"]["chips"] == 1
    assert rec["collective_counts"] == {}


def test_run_cell_granite_decode(tmp_path):
    rec = dryrun.run_cell("granite-20b", "decode_32k", out_dir=str(tmp_path))
    files = os.listdir(tmp_path)
    assert files == ["granite-20b__decode_32k__16x16.json"]
    with open(tmp_path / files[0]) as f:
        assert json.load(f)["roofline"] == json.loads(json.dumps(
            rec["roofline"]))
    rf = rec["roofline"]
    assert rf["chips"] == 256
    assert rf["per_chip"]["flops"] > 0
    assert all(t >= 0 for t in rf["terms_seconds"].values())
    assert rf["dominant"] in rf["terms_seconds"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["collective_counts"]["all-reduce"] > 0


def test_production_meshes():
    mesh = make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16} and mesh.size == 256
    assert {d.type for d in mesh.device_list} == {"meta"}
    pod = make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_local_mesh()
