"""The port's expert parallelism (``repro_torch.models.moe.moe_apply``
over a (data, model) mesh, both mapped modes) against the reference's
mapped ``repro.models.moe.moe_apply`` under ``shard_map``, run once in a
subprocess on 8 forced host devices (as ``tests/test_multidevice.py``
runs it), on the same weights (the reference's ``moe_init`` tree, saved
by the subprocess and loaded into the port's ``MoE``) and numpy-seeded
inputs, in float32; the port on ``make_mesh(shape, ("data", "model"),
devices=["cpu"] * n)``.

Tolerances: outputs within OUT_TOL = 1e-5 absolute and the aux loss
within AUX_TOL = 1e-6 of the reference's mapped run (the mapped combine
sums each shard's partial output, then the shards, in another order
than XLA's psum); each shard's kept assignments (its dispatch slots and
keep mask, from its own tokens' capacity) bitwise the reference's,
computed by the reference's own lines on the shard's tokens.  At model
level, deepseek-v2's SMOKE prefill and two decode steps on the mesh
within LOGIT_TOL = 1e-4 of the reference's model on the same mesh.
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
from repro_torch.models import ModelConfig
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.sharding import make_mesh

OUT_TOL = 1e-5
AUX_TOL = 1e-6
LOGIT_TOL = 1e-4

#: tests/test_multidevice.py's config (its capacity factor 8.0 is
#: dropless).
KW = dict(name="moe-t", num_layers=1, d_model=32, num_heads=2,
          num_kv_heads=2, d_ff=64, vocab_size=64, num_experts=8, top_k=2,
          d_ff_expert=16, param_dtype="float32", dtype="float32")

#: name -> (config: "ref" or an arch whose SMOKE config it is, capacity
#: factor, x shape, mesh shape, expert_tp).  Dropless is 8.0; 0.5 drops
#: assignments on every shard's capacity.
CASES = {
    "ref-ep": ("ref", 8.0, (4, 16, 32), (2, 4), False),
    "ref-tp": ("ref", 8.0, (4, 16, 32), (2, 4), True),
    "ref-tight-ep": ("ref", 0.5, (4, 16, 32), (2, 4), False),
    "ref-tight-tp": ("ref", 0.5, (4, 16, 32), (2, 4), True),
    "deepseek-ep": ("deepseek-v2-236b", 8.0, (4, 12, 64), (2, 4), False),
    "deepseek-tp": ("deepseek-v2-236b", 8.0, (4, 12, 64), (2, 4), True),
    "deepseek-tight-ep": ("deepseek-v2-236b", 0.5, (4, 12, 64), (2, 4),
                          False),
    "deepseek-tight-tp": ("deepseek-v2-236b", 0.5, (4, 12, 64), (2, 4),
                          True),
    "kimi-ep": ("kimi-k2-1t-a32b", 8.0, (2, 20, 64), (2, 4), False),
    "kimi-tp": ("kimi-k2-1t-a32b", 8.0, (2, 20, 64), (2, 4), True),
    "kimi-tight-ep": ("kimi-k2-1t-a32b", 0.5, (2, 20, 64), (2, 4), False),
    "kimi-tight-tp": ("kimi-k2-1t-a32b", 0.5, (2, 20, 64), (2, 4), True),
    # decode shapes whose batch does not split over the data shards: the
    # reference replicates expert-TP's output
    "deepseek-decode-b3-tp": ("deepseek-v2-236b", 1.25, (3, 1, 64), (2, 4),
                              True),
    "kimi-decode-b6-tp-4x2": ("kimi-k2-1t-a32b", 1.25, (6, 1, 64), (4, 2),
                              True),
    "ref-1x2-ep": ("ref", 8.0, (4, 16, 32), (1, 2), False),
    "ref-1x2-tp": ("ref", 8.0, (4, 16, 32), (1, 2), True),
    "ref-4x2-ep": ("ref", 8.0, (4, 16, 32), (4, 2), False),
    "ref-4x2-tp": ("ref", 0.5, (4, 16, 32), (4, 2), True),
    "kimi-4x2-ep": ("kimi-k2-1t-a32b", 0.5, (4, 10, 64), (4, 2), False),
}

#: The model-level runs: deepseek-v2's SMOKE config (its own capacity
#: factor, 1.25) on a (2, 4) mesh, B 2 x S 12, the prefill in EP and two
#: decode steps in the named mode.
MODEL_RUNS = {"decode-ep": False, "decode-tp": True}
MODEL_B, MODEL_S = 2, 12

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import smoke_config
    from repro.models import ModelConfig
    from repro.models import model as rmodel
    from repro.models import moe as rmoe

    KW, cases, model_runs, (B, S), out_dir = json.loads(sys.argv[1])

    def flat(tree, prefix, out):
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        for k, v in items:
            if isinstance(v, (dict, list)):
                flat(v, f"{prefix}{k}.", out)
            else:
                out[f"{prefix}{k}"] = np.asarray(v)
        return out

    def config(which, cf):
        base = ModelConfig(**KW) if which == "ref" else smoke_config(which)
        return dataclasses.replace(base, capacity_factor=cf)

    def shard_keeps(p, x, cfg, dp, ep, expert_tp):
        # each (d, m) shard's dispatch, the reference's own lines
        # (repro/models/moe.py:80-105) on the shard's tokens
        B, S, D = x.shape
        E, K = cfg.num_experts, cfg.top_k
        e_loc = E // ep
        out = []
        for d in range(dp):
            rows = x if expert_tp else x[d * B // dp:(d + 1) * B // dp]
            x2d = jnp.asarray(rows.reshape(-1, D))
            T = x2d.shape[0]
            C = rmoe._capacity(T, cfg)
            logits = jnp.einsum("td,de->te", x2d, p["router"]["w"])
            probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
            _, top_e = jax.lax.top_k(probs, K)
            for m in range(ep):
                le = top_e - m * e_loc
                valid = (le >= 0) & (le < e_loc)
                le = jnp.where(valid, le, e_loc).reshape(-1)
                onehot = jax.nn.one_hot(le, e_loc + 1, dtype=jnp.int32)
                pos = ((jnp.cumsum(onehot, axis=0) - onehot)
                       * onehot).sum(-1)
                keep = (le < e_loc) & (pos < C)
                slot = jnp.where(keep, le * C + pos, e_loc * C)
                out.append((np.asarray(slot), np.asarray(keep),
                            np.asarray(valid.reshape(-1))))
        return out

    for name, (which, cf, xshape, mshape, expert_tp) in cases.items():
        cfg = config(which, cf)
        p = rmoe.moe_init(jax.random.PRNGKey(len(name)), cfg)
        x = np.random.default_rng(len(name) + 100).standard_normal(
            xshape).astype(np.float32)
        mesh = jax.make_mesh(tuple(mshape), ("data", "model"))
        out, aux = jax.jit(lambda p, x: rmoe.moe_apply(
            p, x, cfg, mesh=mesh, data_axes=("data",),
            expert_tp=expert_tp))(p, jnp.asarray(x))
        keeps = shard_keeps(p, x, cfg, mshape[0], mshape[1], expert_tp)
        arrays = flat(p, "p.", {})
        for i, (slot, keep, valid) in enumerate(keeps):
            arrays[f"slot.{i}"] = slot
            arrays[f"keep.{i}"] = keep
            arrays[f"valid.{i}"] = valid
        np.savez(os.path.join(out_dir, name + ".npz"), x=x,
                 out=np.asarray(out), aux=np.asarray(aux), **arrays)

    cfg = smoke_config("deepseek-v2-236b")
    params = rmodel.init(jax.random.PRNGKey(3), cfg)
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    np.savez(os.path.join(out_dir, "model-params.npz"),
             **flat(params, "", {}))
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    host = lambda tree: jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                                     tree)
    for run, expert_tp in model_runs.items():
        cache = rmodel.make_cache(cfg, B, S + 2, concrete=True)
        last, cache = jax.jit(lambda p, t, c: rmodel.prefill(
            p, t, c, cfg, mesh=mesh))(params, jnp.asarray(toks), cache)
        cfg_d = dataclasses.replace(cfg, moe_expert_tp=expert_tp)
        step = jax.jit(lambda p, t, c, pos: rmodel.decode_step(
            p, t, c, pos, cfg_d, mesh=mesh))
        logits, fed = [np.asarray(last)], []
        for i in range(2):
            # host arrays in, so the step's inputs carry no sharding
            tok = np.asarray(logits[-1]).argmax(-1).astype(np.int32)
            lg, cache = step(params, jnp.asarray(tok), host(cache),
                             jnp.int32(S + i))
            fed.append(tok)
            logits.append(np.asarray(lg))
        np.savez(os.path.join(out_dir, "model-" + run + ".npz"),
                 toks=toks, logits=np.stack(logits), fed=np.stack(fed))
""")


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's mapped runs, once: {case: npz contents}."""
    out = tmp_path_factory.mktemp("moe_ep")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    arg = json.dumps([KW, CASES, MODEL_RUNS, [MODEL_B, MODEL_S], str(out)])
    r = subprocess.run([sys.executable, "-c", SCRIPT, arg],
                       cwd=os.path.join(os.path.dirname(__file__), ".."),
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    return {name: dict(np.load(os.path.join(out, name + ".npz")))
            for name in list(CASES) + ["model-params"]
            + [f"model-{k}" for k in MODEL_RUNS]}


def _config(which: str, cf: float) -> ModelConfig:
    base = ModelConfig(**KW) if which == "ref" else \
        tconfigs.smoke_config(which)
    return dataclasses.replace(base, capacity_factor=cf)


def _port(ref: dict, cfg: ModelConfig) -> tmoe.MoE:
    mod = tmoe.MoE(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    mod.load_state_dict({k[2:]: torch.tensor(v) for k, v in ref.items()
                         if k.startswith("p.")}, strict=True)
    return mod


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * math.prod(shape))


class _Dispatches:
    """Records every ``dispatch`` call's (slot, keep) while open."""

    def __init__(self, monkeypatch) -> None:
        self.calls = []
        real = tmoe.dispatch

        def spy(top_e, e_offset, e_loc, capacity):
            slot, keep = real(top_e, e_offset, e_loc, capacity)
            self.calls.append((slot, keep))
            return slot, keep

        monkeypatch.setattr(tmoe, "dispatch", spy)


@pytest.mark.parametrize("name", list(CASES))
def test_mapped_moe_matches_reference(name, ref_runs, monkeypatch):
    which, cf, _, mshape, expert_tp = CASES[name]
    ref = ref_runs[name]
    cfg = _config(which, cf)
    mod = _port(ref, cfg)
    spy = _Dispatches(monkeypatch)
    out, aux = tmoe.moe_apply(mod, torch.tensor(ref["x"]), cfg,
                              mesh=_mesh(mshape), expert_tp=expert_tp)
    np.testing.assert_allclose(out.numpy(), ref["out"], rtol=0,
                               atol=OUT_TOL)
    assert abs(float(aux) - float(ref["aux"])) <= AUX_TOL
    # one dispatch a (d, m) shard, in row-major order
    assert len(spy.calls) == math.prod(mshape)
    drops = 0
    for i, (slot, keep) in enumerate(spy.calls):
        np.testing.assert_array_equal(slot.numpy(), ref[f"slot.{i}"])
        np.testing.assert_array_equal(keep.numpy(), ref[f"keep.{i}"])
        drops += int((ref[f"valid.{i}"] & ~ref[f"keep.{i}"]).sum())
    assert (drops > 0) == (cf < 1), drops


def test_ep_batch_must_split():
    """EP raises where the batch does not split over the data shards
    (the reference's shard_map cannot split it either); expert-TP takes
    such a batch whole."""
    cfg = _config("ref", 8.0)
    mod = tmoe.MoE(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    x = torch.randn((3, 2, 32), generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match=r"\(3, 2, 32\).*2 data shards"):
        tmoe.moe_apply(mod, x, cfg, mesh=_mesh((2, 4)))
    out, _ = tmoe.moe_apply(mod, x, cfg, mesh=_mesh((2, 4)), expert_tp=True)
    want, _ = tmoe.moe_apply(mod, x, cfg)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0,
                               atol=OUT_TOL)


def test_mapped_weights_are_views():
    """EP's expert slices are views of the stacked weights (no copy);
    expert-TP's FFN slices are strided views."""
    cfg = _config("ref", 8.0)
    mod = tmoe.MoE(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    mesh = _mesh((2, 4))
    wg = mod.experts.w_gate
    by_m = mesh.parts(wg, 0, "model")
    assert [t.data_ptr() for t in by_m] == \
        [wg.data_ptr() + m * 2 * 32 * 16 * wg.element_size()
         for m in range(4)]
    assert all(t.is_contiguous() and t.shape == (2, 32, 16) for t in by_m)
    by_f = mesh.parts(by_m[1], 2, ("data",))
    assert [t.shape for t in by_f] == [(2, 32, 8)] * 2
    assert by_f[1].data_ptr() == by_m[1].data_ptr() + 8 * wg.element_size()


def test_pod_mesh_grid():
    """A (pod, data, model) mesh: the data shards run over (pod, data) in
    row-major order, as the reference's ``data_axes=("pod", "data")``
    splits the batch; an axis no group names is a replica axis."""
    devs = [f"cpu:{i}" for i in range(8)]
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=devs)
    grid = mesh.device_grid(("pod", "data"), "model")
    assert grid.shape == (4, 2)
    assert [str(d) for d in grid.reshape(-1)] == devs
    assert [str(d) for d in mesh.device_grid("data", "model").reshape(-1)] \
        == ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
    cfg = _config("ref", 8.0)
    mod = tmoe.MoE(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    x = torch.randn((4, 4, 32), generator=torch.Generator().manual_seed(2))
    want, _ = tmoe.moe_apply(mod, x, cfg)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                     devices=["cpu"] * 8)
    for tp in (False, True):
        got, _ = tmoe.moe_apply(mod, x, cfg, mesh=mesh,
                                data_axes=("pod", "data"), expert_tp=tp)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=OUT_TOL)


@pytest.mark.parametrize("run", list(MODEL_RUNS))
def test_model_on_mesh_matches_reference(run, ref_runs):
    """deepseek-v2's SMOKE model on a (2, 4) mesh: the prefill in EP and
    two decode steps (fed the reference's greedy tokens) in EP or
    expert-TP, logits within LOGIT_TOL of the reference's model on the
    same mesh."""
    cfg = tconfigs.smoke_config("deepseek-v2-236b")
    ref = ref_runs[f"model-{run}"]
    model = tmodel.params_from_reference(
        _unflatten(ref_runs["model-params"]), cfg, device="cpu")
    mesh = _mesh((2, 4))
    cfg_d = dataclasses.replace(cfg, moe_expert_tp=MODEL_RUNS[run])
    cache = tmodel.make_cache(cfg, MODEL_B, MODEL_S + 2, concrete=True,
                              device="cpu")
    last, cache = tmodel.prefill(model, torch.tensor(ref["toks"]), cache,
                                 cfg, mesh=mesh)
    logits = [last]
    for i in range(2):
        lg, cache = tmodel.decode_step(model, torch.tensor(ref["fed"][i]),
                                       cache, MODEL_S + i, cfg_d, mesh=mesh)
        logits.append(lg)
    np.testing.assert_allclose(torch.stack(logits).numpy(), ref["logits"],
                               rtol=0, atol=LOGIT_TOL)


def _unflatten(flat: dict) -> dict:
    """The reference's parameter tree from its dotted leaf names
    (``segments`` a list of segment dicts)."""
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
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
