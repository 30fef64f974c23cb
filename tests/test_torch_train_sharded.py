"""The port's sharded train step (``repro_torch.train.step.make_train_step``
with ``mesh=`` and ``shard=make_shard_fn(...)``: data parallelism over a
(data, model) mesh, ZeRO-1, the MoE layers mapped over each data
shard's row) against the reference, run once in a subprocess on 8
forced host devices (as ``tests/test_multidevice.py`` runs it), and
against the port's own one-device step.  The port runs on
``make_mesh(shape, ("data", "model"), devices=["cpu"] * 8)``, from the
reference's init weights, on the same numpy-seeded batches.

* (a) ``tests/test_multidevice.py``'s own case (its config "t", B 8 x
  32, lr 1e-3) on the meshes (2, 4), (4, 2), (8, 1) and (1, 8), with
  ``microbatch`` 1 and 2: loss and every element of the parameters
  after one step within its 1e-4 of the reference's one-device jitted
  step; gradients within GRAD_REL of each leaf's largest element and
  loss within LOSS_REL_PORT of the port's one-device step.
* (b) The ten archs' SMOKE configs on a (2, 4) mesh, B 4, remat
  "full", ``microbatch`` 1 and 2, MoE archs at capacity factor 8.0, at
  ``tests/test_torch_train_archs.py``'s tolerances (loss, ce, grad
  norm 1e-5 relative; parameters rtol 1e-4, atol 2e-4, xlstm-1p3b
  1e-3).  A dense arch is held to the reference's one-device step and
  to the port's (gradients besides, GRAD_REL).  An MoE arch's aux is
  each (d, m) shard's router statistics over its own tokens, averaged:
  its ce is held to the port's one-device step, and its loss, aux,
  grad norm and parameters to the reference's sharded step (its own
  ``make_train_step(mesh=, shard=make_shard_fn(...))`` on the mesh,
  the parameters and batch placed by its spec maps), whose mapped
  ``moe_apply`` computes that aux.  deepseek-v2 runs again under
  ``moe_expert_tp`` ("deepseek-v2-236b+tp", ``microbatch`` 2): the
  port runs its steps replicated (expert-TP takes every token), held
  the same way.  The
  reference's sharded step runs under jax 0.9 on a mesh of Auto axes; on
  ``jax.make_mesh``'s default Explicit axes it raises
  ``ShardingTypeError``.
* (c) A batch that does not divide (B 3 on dp 2) runs replicated: the
  parameters and metrics bitwise the one-device step's.
* (d) The MoE block's gradient: the port's mapped block under autograd
  against ``jax.grad`` of the reference's mapped ``moe_apply`` (Auto
  mesh), deepseek-v2 SMOKE, EP and expert-TP, capacity 8.0 and 0.5, on
  ``sum(out * cot) + aux``: every gradient within MOE_GRAD_TOL of its
  largest element.
* A mesh whose data shards name a device other than the model's is
  refused before any work.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import ModelConfig, segments
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.sharding import make_mesh
from repro_torch.sharding.rules import ExecConfig, make_shard_fn
from repro_torch.train import step as tstep
from repro_torch.train.optim import AdamWConfig, adamw_init

ARCHS = ["xlstm-1p3b", "minitron-4b", "starcoder2-15b", "phi3-mini-3p8b",
         "granite-20b", "musicgen-large", "deepseek-v2-236b",
         "kimi-k2-1t-a32b", "qwen2-vl-2b", "zamba2-7b"]
MOE_ARCHS = ["deepseek-v2-236b", "kimi-k2-1t-a32b"]
#: (b)'s cases: the ten archs, and deepseek-v2 under expert-TP.
CASES = ARCHS + ["deepseek-v2-236b+tp"]
#: (b)'s microbatch counts: 1 and 2, the expert-TP case 2 alone.
MBS = {c: (2,) if c.endswith("+tp") else (1, 2) for c in CASES}

PARAM_TOL = 1e-4          # tests/test_multidevice.py's loss and params
LOSS_TOL = 1e-4
GRAD_REL = 1e-5           # of each gradient leaf's largest element
LOSS_REL_PORT = 1e-6
LOSS_REL = 1e-5           # tests/test_torch_train_archs.py's
RTOL = 1e-4
SMOKE_ATOL = {"xlstm-1p3b": 1e-3}
SMOKE_ATOL_DEFAULT = 2e-4
MOE_GRAD_TOL = 1e-5

#: tests/test_multidevice.py's config "t".
T_KW = dict(name="t", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=128,
            param_dtype="float32", dtype="float32")
T_MESHES = [(2, 4), (4, 2), (8, 1), (1, 8)]
#: The MoE block cases: name -> (expert_tp, capacity factor).
MOE_CASES = {"ep": (False, 8.0), "tp": (True, 8.0), "tight-ep": (False, 0.5),
             "tight-tp": (True, 0.5)}
MOE_X = (4, 12, 64)

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import smoke_config
    from repro.models import ModelConfig, segments
    from repro.models import model as rmodel
    from repro.models import moe as rmoe
    from repro.sharding import rules
    from repro.train.optim import AdamWConfig, adamw_init
    from repro.train.step import make_train_step

    T_KW, archs, moe_archs, moe_cases, mbs, d = json.loads(sys.argv[1])
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    opt = AdamWConfig(lr=1e-3)

    def names_of(path):
        return [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]

    def tree_from_port(w, shapes, cfg=None):
        # the port's {dotted name: array} as the reference's tree, each
        # segment's layers stacked on its leading axis
        leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        out = []
        for path, leaf in leaves:
            n = names_of(path)
            if n[0] == "segments":
                seg = segments(cfg)[int(n[1])]
                ki = int(n[2].split("_")[0])
                rest = ".".join(n[3:])
                a = np.stack([w[f"layers.{seg.start_layer + r * len(seg.kinds) + ki}.{rest}"]
                              for r in range(seg.repeats)])
            else:
                a = w[".".join(n)]
            out.append(jnp.asarray(a, leaf.dtype))
        return jax.tree_util.tree_unflatten(treedef, out)

    def flat(tree, prefix, out):
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        for k, v in items:
            if isinstance(v, (dict, list)):
                flat(v, f"{prefix}{k}.", out)
            else:
                out[f"{prefix}{k}"] = np.asarray(v)
        return out

    def place(tree, specs):
        return jax.device_put(tree, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P)))

    def one_device(cfg, params, batch, mb):
        step = jax.jit(make_train_step(cfg, rules.ExecConfig(microbatch=mb),
                                       opt))
        return step(params, adamw_init(params, opt), batch)

    def sharded(cfg, params, batch, mb):
        ex = rules.ExecConfig(microbatch=mb,
                              moe_expert_tp=cfg.moe_expert_tp)
        B = batch["tokens"].shape[0]
        step = make_train_step(cfg, ex, opt, mesh=mesh,
                               data_axes=("data",),
                               shard=rules.make_shard_fn(mesh, ex, B))
        pspecs = rules.param_specs(jax.eval_shape(lambda: params), cfg,
                                   mesh, ex)
        return jax.jit(step)(place(params, pspecs), adamw_init(params, opt),
                             place(batch, rules.batch_specs(batch, mesh)))

    def model_params(name, cfg):
        shapes = jax.eval_shape(lambda: rmodel.init(jax.random.PRNGKey(0),
                                                    cfg))
        return tree_from_port(np.load(f"{d}/{name}-w.npz"), shapes, cfg)

    def run(name, cfg, mbs, fn):
        params = model_params(name, cfg)
        batch = {k: jnp.asarray(v)
                 for k, v in np.load(f"{d}/{name}-in.npz").items()}
        out = {}
        for mb in mbs:
            p2, _, m = fn(cfg, params, batch, mb)
            out.update(flat(p2, f"p{mb}.", {}))
            out.update({f"mb{mb}.{k}": np.asarray(v) for k, v in m.items()})
        return params, batch, out

    # (a) tests/test_multidevice.py's case: the one-device step
    cfg = ModelConfig(**T_KW)
    _, _, out = run("t", cfg, (1, 2), one_device)
    np.savez(d + "/t-out.npz", **out)

    # (b) the ten archs: dense ones' one-device step, MoE ones' sharded
    for case in archs:
        arch, tp = case.partition("+")[::2]
        cfg = dataclasses.replace(smoke_config(arch), remat="full",
                                  moe_expert_tp=tp == "tp")
        if arch in moe_archs:
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
            _, _, out = run(case, cfg, mbs[case], sharded)
        else:
            _, _, out = run(case, cfg, (1,), one_device)
        np.savez(f"{d}/{case}-out.npz", **out)

    # (d) the mapped MoE block's gradients
    for name, (tp, cf) in moe_cases.items():
        cfg = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                                  capacity_factor=cf)
        p = tree_from_port(np.load(f"{d}/moe-{name}-w.npz"),
                           jax.eval_shape(lambda: rmoe.moe_init(
                               jax.random.PRNGKey(0), cfg)))
        io = np.load(f"{d}/moe-{name}-in.npz")

        def loss(p, x):
            o, aux = rmoe.moe_apply(p, x, cfg, mesh=mesh,
                                    data_axes=("data",), expert_tp=tp)
            return jnp.sum(o * io["cot"]) + aux, (o, aux)

        (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(io["x"]))
        np.savez(f"{d}/moe-{name}-out.npz", out=np.asarray(o),
                 aux=np.asarray(aux), gx=np.asarray(gx),
                 **flat(gp, "g.", {}))
""")


def _smoke_batch(cfg, B: int, S: int = 32, seed: int = 0) -> dict:
    """``tests/test_torch_train_archs.py``'s batch at B rows."""
    rng = np.random.default_rng(seed)
    shape = (B, S) if cfg.num_codebooks == 1 else (B, S, cfg.num_codebooks)
    toks = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.frontend == "vision":
        batch["extra_embeds"] = rng.normal(
            size=(B, S, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S))
        batch["positions"] = np.ascontiguousarray(pos.astype(np.int32))
    return batch


def _t_batch(B: int = 8) -> dict:
    toks = np.random.default_rng(0).integers(0, 128, size=(B, 32)
                                             ).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _arch_cfg(case: str) -> ModelConfig:
    """(b)'s config: the arch's SMOKE config, remat "full", an MoE arch
    at capacity 8.0, expert-TP where ``case`` ends in "+tp"."""
    arch, tp = case.partition("+")[::2]
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), remat="full",
                              moe_expert_tp=tp == "tp")
    if arch in MOE_ARCHS:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def _moe_cfg(name: str) -> ModelConfig:
    return dataclasses.replace(tconfigs.smoke_config("deepseek-v2-236b"),
                               capacity_factor=MOE_CASES[name][1])


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * math.prod(shape))


def _weights(module) -> dict:
    return {k: p.detach().numpy().copy() for k, p in
            module.named_parameters()}


def _step(cfg, weights: dict, batch, mb, mesh=None):
    """One port step from ``weights`` -> (parameters after the step,
    metrics as floats, the gradients AdamW was given), the gradients
    caught by wrapping the step module's update functions."""
    model = tmodel.DecoderLM(cfg, generator=torch.Generator().manual_seed(0),
                             device="meta")
    model.load_state_dict({k: torch.tensor(v) for k, v in weights.items()},
                          assign=True)
    ex = ExecConfig(microbatch=mb)
    seen = {}

    def hooked(fn):
        def update(grads, *a, **kw):
            seen.update({k: g.detach().clone() for k, g in grads.items()})
            return fn(grads, *a, **kw)
        return update

    real = tstep.adamw_update
    tstep.adamw_update = hooked(real)
    try:
        kw = {} if mesh is None else dict(
            mesh=mesh, shard=make_shard_fn(mesh, ex, len(batch["tokens"])))
        step = tstep.make_train_step(cfg, ex, AdamWConfig(lr=1e-3), **kw)
        _, met = step(model, adamw_init(model, AdamWConfig()), batch)
    finally:
        tstep.adamw_update = real
    return _weights(model), {k: float(v) for k, v in met.items()}, seen


def _moe_grads(name: str, weights: dict, io: dict):
    """The port's mapped block on (2, 4) under autograd: (out, aux,
    {"gx" and "g.<weight>": gradient})."""
    tp, _ = MOE_CASES[name]
    cfg = _moe_cfg(name)
    mod = tmoe.MoE(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    mod.load_state_dict({k: torch.tensor(v) for k, v in weights.items()})
    mod.requires_grad_(True)
    x = torch.tensor(io["x"], requires_grad=True)
    out, aux = tmoe.moe_apply(mod, x, cfg, mesh=_mesh((2, 4)), expert_tp=tp)
    loss = torch.sum(out * torch.tensor(io["cot"])) + aux
    names = [n for n, _ in mod.named_parameters()]
    grads = torch.autograd.grad(loss, [x] + [mod.get_parameter(n)
                                             for n in names])
    return out.detach().numpy(), float(aux.detach()), {
        k: g.numpy() for k, g in zip(["gx"] + [f"g.{n}" for n in names],
                                     grads)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run, once: the port's weights and inputs are written, the
    reference's subprocess started on them, and the port's steps run
    while it works.  -> {"ref": {name: npz contents}, "port": {...}}."""
    d = tmp_path_factory.mktemp("train_sharded")
    weights, batches, moe_io = {}, {}, {}
    for name, cfg, batch in [("t", ModelConfig(**T_KW), _t_batch())] + [
            (a, _arch_cfg(a), _smoke_batch(_arch_cfg(a), 4)) for a in CASES]:
        weights[name] = _weights(tmodel.init(
            cfg, generator=torch.Generator().manual_seed(len(name)),
            device="cpu"))
        batches[name] = batch
        np.savez(d / f"{name}-w.npz", **weights[name])
        np.savez(d / f"{name}-in.npz", **batch)
    for name in MOE_CASES:
        rng = np.random.default_rng(len(name) + 300)
        moe_io[name] = {k: rng.standard_normal(MOE_X).astype(np.float32)
                        for k in ("x", "cot")}
        weights["moe-" + name] = _weights(tmoe.MoE(
            _moe_cfg(name), generator=torch.Generator().manual_seed(
                len(name)), device="cpu"))
        np.savez(d / f"moe-{name}-w.npz", **weights["moe-" + name])
        np.savez(d / f"moe-{name}-in.npz", **moe_io[name])
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    arg = json.dumps([T_KW, CASES, MOE_ARCHS, MOE_CASES, MBS, str(d)])
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, arg],
        cwd=os.path.join(os.path.dirname(__file__), ".."), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    threads = torch.get_num_threads()
    # one thread while the reference compiles beside it: the port's
    # SMOKE steps are small, and spinning threads would slow both
    torch.set_num_threads(1)
    try:
        port = {}
        cfg = ModelConfig(**T_KW)
        for mb in (1, 2):
            port[("t", None, mb)] = _step(cfg, weights["t"], batches["t"],
                                          mb)
            for shape in T_MESHES:
                port[("t", shape, mb)] = _step(cfg, weights["t"],
                                               batches["t"], mb,
                                               _mesh(shape))
            for arch in (a for a in CASES if mb in MBS[a]):
                for mesh in (None, (2, 4)):
                    port[(arch, mesh, mb)] = _step(
                        _arch_cfg(arch), weights[arch], batches[arch], mb,
                        None if mesh is None else _mesh(mesh))
        for name in MOE_CASES:
            port["moe-" + name] = _moe_grads(name, weights["moe-" + name],
                                             moe_io[name])
        torch.set_num_threads(threads)
        log, _ = proc.communicate(timeout=900)
    finally:
        torch.set_num_threads(threads)
        proc.kill()
    assert proc.returncode == 0, log
    names = ["t"] + CASES + [f"moe-{n}" for n in MOE_CASES]
    return {"ref": {n: dict(np.load(d / f"{n}-out.npz")) for n in names},
            "port": port}


def _unflatten(flat: dict, prefix: str) -> dict:
    """The reference's parameter tree from its dotted leaf names under
    ``prefix`` (``segments`` a list of segment dicts)."""
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split(".")
        node = tree
        for part in path:
            if isinstance(node, list):
                while len(node) <= int(part):
                    node.append({})
                node = node[int(part)]
            else:
                node = node.setdefault(part,
                                       [] if part == "segments" else {})
        node[leaf] = v
    return tree


def _ref_flat(r: dict, prefix: str, cfg) -> dict:
    """The reference's tree under ``prefix`` as {port name: array}."""
    tree = _unflatten(r, prefix)
    for seg, layers in zip(segments(cfg), tree["segments"]):
        for ki, kind in enumerate(seg.kinds):
            layers.setdefault(f"{ki}_{kind}", {})   # a weightless kind
    return tmodel.flat_from_reference(tree, cfg)


def _assert_grads_close(got: dict, want: dict, rel: float = GRAD_REL):
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = np.asarray(want[k], np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(g, np.float64) - w).max())
        assert err <= rel * scale, (k, err, scale)


def _assert_params_close(got: dict, want: dict, rtol: float,
                         atol: float) -> None:
    """Every element of every parameter within rtol / atol of
    ``want``'s."""
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        g = np.asarray(g, np.float64)
        w = np.asarray(want[k], np.float64)
        bad = np.abs(g - w) > atol + rtol * np.abs(w)
        assert not bad.any(), (k, float(np.abs(g - w).max()))


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("shape", T_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_multidevice_case(shape, mb, runs):
    """(a): ``tests/test_multidevice.py``'s sharded step on the port."""
    r, cfg = runs["ref"]["t"], ModelConfig(**T_KW)
    p1, met1, g1 = runs["port"][("t", None, mb)]
    p2, met2, g2 = runs["port"][("t", shape, mb)]
    assert abs(met2["loss"] - float(r[f"mb{mb}.loss"])) < LOSS_TOL
    assert met2["loss"] == pytest.approx(met1["loss"], rel=LOSS_REL_PORT)
    _assert_grads_close(g2, g1)
    _assert_params_close(p2, _ref_flat(r, f"p{mb}.", cfg), 0.0, PARAM_TOL)


@pytest.mark.parametrize("arch,mb", [(a, mb) for a in CASES
                                     for mb in MBS[a]])
def test_arch_sharded_step(arch, mb, runs):
    """(b): each arch's SMOKE config on the (2, 4) mesh."""
    r, cfg = runs["ref"][arch], _arch_cfg(arch)
    p1, met1, g1 = runs["port"][(arch, None, mb)]
    p2, met2, g2 = runs["port"][(arch, (2, 4), mb)]
    atol = SMOKE_ATOL.get(arch, SMOKE_ATOL_DEFAULT)
    assert np.isfinite(met2["loss"])
    assert met2["ce"] == pytest.approx(met1["ce"], rel=LOSS_REL)
    if cfg.is_moe:
        # the reference's sharded step: the same mapped aux
        for key in ("loss", "ce", "aux", "grad_norm"):
            assert met2[key] == pytest.approx(float(r[f"mb{mb}.{key}"]),
                                              rel=LOSS_REL), key
        _assert_params_close(p2, _ref_flat(r, f"p{mb}.", cfg), RTOL, atol)
        return
    for key in ("loss", "grad_norm"):
        assert met2[key] == pytest.approx(met1[key], rel=LOSS_REL), key
        assert met2[key] == pytest.approx(float(r[f"mb1.{key}"]),
                                          rel=LOSS_REL), key
    _assert_grads_close(g2, g1)
    _assert_params_close(p2, p1, RTOL, atol)
    if mb == 1:
        _assert_params_close(p2, _ref_flat(r, "p1.", cfg), RTOL, atol)


@pytest.mark.parametrize("mb", [1, 3])
def test_indivisible_batch_runs_replicated(mb):
    """(c): B 3 on dp 2 runs once, replicated: bitwise the one-device
    step (``microbatch`` 3 gives microbatches of one row)."""
    cfg = ModelConfig(**T_KW)
    w = _weights(tmodel.init(cfg, generator=torch.Generator().manual_seed(5),
                             device="cpu"))
    batch = _t_batch(3)
    p1, met1, g1 = _step(cfg, w, batch, mb)
    p2, met2, g2 = _step(cfg, w, batch, mb, _mesh((2, 4)))
    assert met1 == met2
    for k in p1:
        np.testing.assert_array_equal(p2[k], p1[k], err_msg=k)
        assert torch.equal(g2[k], g1[k]), k
        assert not np.array_equal(p1[k], w[k]), k


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_mapped_moe_gradients(name, runs):
    """(d): the mapped block's gradients against ``jax.grad``."""
    r = runs["ref"]["moe-" + name]
    out, aux, grads = runs["port"]["moe-" + name]
    np.testing.assert_allclose(out, r["out"], rtol=0, atol=1e-5)
    assert abs(aux - float(r["aux"])) <= 1e-6
    assert sorted(grads) == sorted(k for k in r if k.startswith("g"))
    for key, g in grads.items():
        w = np.asarray(r[key], np.float64)
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= MOE_GRAD_TOL * max(float(np.abs(w).max()), 1e-30), \
            (key, err)


@pytest.mark.parametrize("devices", [["cpu:0", "cpu:1"] * 4,
                                     ["meta"] * 8])
def test_distinct_devices_refused(devices):
    """A mesh whose data shards name a device other than the model's
    raises before any work: the parameters stay as they were."""
    cfg = ModelConfig(**T_KW)
    model = tmodel.init(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    before = _weights(model)
    mesh = make_mesh((2, 4), ("data", "model"), devices=devices)
    ex = ExecConfig()
    step = tstep.make_train_step(cfg, ex, AdamWConfig(lr=1e-3), mesh=mesh,
                                 shard=make_shard_fn(mesh, ex, 8))
    with pytest.raises(NotImplementedError, match="not ported"):
        step(model, adamw_init(model, AdamWConfig()), _t_batch())
    for k, v in _weights(model).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_data_row_submesh():
    """``BankMesh.data_row``: a data shard's row of the (data, model)
    grid, its data axes of extent 1."""
    devs = [f"cpu:{i}" for i in range(8)]
    mesh = make_mesh((2, 4), ("data", "model"), devices=devs)
    row = mesh.data_row(1)
    assert row.shape == {"data": 1, "model": 4}
    assert [str(d) for d in row.device_list] == devs[4:]
    pod = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=devs)
    row = pod.data_row(2, ("pod", "data"))
    assert row.shape == {"pod": 1, "data": 1, "model": 2}
    assert [str(d) for d in row.device_list] == devs[4:6]
    flat = make_mesh((8,), ("data",), devices=devs)
    assert flat.data_row(3).shape == {"data": 1}
    assert str(flat.data_row(3).primary) == "cpu:3"
