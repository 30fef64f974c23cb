"""The port's activation sharding callback and cache specs
(``repro_torch.sharding.rules``: ``make_shard_fn``, ``cache_specs``) and
the models' ``shard`` call sites, against the reference's.

* ``make_shard_fn``: for every kind (and one the rules do not know), at
  ranks 3 and 4 and wrong ranks, on dims that divide the ``model`` axis
  and dims that do not, on the (2, 4), (4, 2) and (8, 1) (data, model)
  meshes, with ``seq_shard_activations`` on and off and a batch that
  divides the data axis and one that does not, the port's
  ``shard.spec(x, kind)`` equals the PartitionSpec the reference's
  ``shard(x, kind)`` constrains ``x`` to (None where it returns ``x``
  unconstrained).  The reference runs once in a subprocess on 8 forced
  host devices, ``jax.lax.with_sharding_constraint`` wrapped there (and
  only there) to record its sharding.  The port's callback returns the
  tensor itself.
* The call sites: a recording ``shard`` sees the same (kind, shape)
  calls, in order, in the port's ``forward``, ``prefill`` and
  ``decode_step`` as in the reference's, for the ten archs' SMOKE
  configs.  The reference is traced by ``jax.eval_shape`` with
  ``scan_layers=False``: its unrolled loop traces each layer's segment
  body once a layer, the body ``lax.scan`` traces once a segment.  The
  prefill's cache holds exactly the prompt (the reference's MLA prefill
  decompresses the whole cache, the port's the filled prefix, so their
  ``k_nope`` and ``v`` agree in shape only where the two are one).
* ``cache_specs``: for the ten archs at their published sizes (the
  reference's cache from ``make_cache`` as ShapeDtypeStructs, the port's
  on ``meta``), a batch that divides the data axes and one that does
  not, on stub meshes of (2, 4), (16, 16) and (2, 16, 16) (pod, data,
  model): each layer's leaf spec the reference's stacked spec without
  its leading (layer-axis) entry.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as rmodel
from repro.models.config import segments
from repro.sharding import rules as rrules
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.sharding import make_mesh
from repro_torch.sharding import rules as trules

KINDS = ["heads", "heads_bhs", "ffn", "full_seq", "resid", "logits",
         "other"]
SHAPES = [(8, 16, 12), (8, 6, 10), (3, 5, 7), (4, 16, 24),
          (8, 16, 12, 8), (8, 6, 3, 10), (3, 4, 5, 6), (2, 8, 2, 12),
          (8, 16), (2, 3, 4, 5, 6)]
MESHES = [(2, 4), (4, 2), (8, 1)]
#: (mesh shape, seq_shard_activations, batch) per case.
CASES = {f"{m[0]}x{m[1]}-{'seq' if seq else 'noseq'}-b{b}": (m, seq, b)
         for m in MESHES for seq in (False, True) for b in (8, 3)}

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp
    from repro.sharding import rules

    cases, kinds, shapes = json.loads(sys.argv[1])
    seen = []
    jax.lax.with_sharding_constraint = \\
        lambda x, s: seen.append(s.spec) or x

    def norm(spec):
        out = []
        for e in spec:
            if isinstance(e, (tuple, list)):
                e = e[0] if len(e) == 1 else list(e)
            out.append(e)
        return out

    out = {}
    for name, (mshape, seq, batch) in cases.items():
        mesh = jax.make_mesh(tuple(mshape), ("data", "model"))
        shard = rules.make_shard_fn(
            mesh, rules.ExecConfig(seq_shard_activations=seq), batch)
        for kind in kinds:
            for shape in shapes:
                seen.clear()
                x = jnp.zeros(shape)
                assert shard(x, kind) is x
                out[f"{name}/{kind}/{shape}"] = \\
                    norm(seen[0]) if seen else None
    print(json.dumps(out))
""")


def _norm(spec, rank: int):
    """A spec as a list of rank entries: None, an axis name, or a list
    of two or more names (a one-name tuple is that name); None stays
    None."""
    if spec is None:
        return None
    out = []
    for e in tuple(spec) + (None,) * (rank - len(tuple(spec))):
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else list(e)
        out.append(e)
    return out


@pytest.fixture(scope="module")
def ref_specs():
    """The reference's spec of every (case, kind, shape), once."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    arg = json.dumps([CASES, KINDS, SHAPES])
    r = subprocess.run([sys.executable, "-c", SCRIPT, arg],
                       cwd=os.path.join(os.path.dirname(__file__), ".."),
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(CASES))
def test_shard_fn_specs(case, kind, ref_specs):
    mshape, seq, batch = CASES[case]
    mesh = make_mesh(mshape, ("data", "model"), devices=["cpu"] * 8)
    shard = trules.make_shard_fn(
        mesh, trules.ExecConfig(seq_shard_activations=seq), batch)
    for shape in SHAPES:
        x = torch.zeros(shape)
        assert shard(x, kind) is x
        want = ref_specs[f"{case}/{kind}/{list(shape)}"]
        got = _norm(shard.spec(x, kind), len(shape))
        assert got == want, (shape, got, want)


# ---------------------------------------------------------------------------
# call sites
# ---------------------------------------------------------------------------

B, S = 2, 8
FNS = ["forward", "prefill", "decode"]


def _inputs(cfg):
    rng = np.random.default_rng(3)
    nb = cfg.num_codebooks
    shape = (B, S) if nb == 1 else (B, S, nb)
    toks = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    extra = pos = None
    if cfg.frontend == "vision":
        extra = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        pos = np.ascontiguousarray(np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None], (3, B, S)))
    tok1 = toks[:, 0] if nb == 1 else toks[:, 0, :]
    return toks, extra, pos, tok1


def _ref_calls(arch: str, fn: str):
    cfg = dataclasses.replace(rconfigs.smoke_config(arch), scan_layers=False)
    pshape = jax.eval_shape(lambda k: rmodel.init(k, cfg),
                            jax.random.PRNGKey(0))
    toks, extra, pos, tok1 = _inputs(cfg)
    calls = []

    def rec(x, kind):
        calls.append((kind, tuple(x.shape)))
        return x

    if fn == "forward":
        jax.eval_shape(lambda p: rmodel.forward(
            p, jnp.asarray(toks), cfg, positions=None if pos is None else
            jnp.asarray(pos), extra_embeds=None if extra is None else
            jnp.asarray(extra), shard=rec), pshape)
    elif fn == "prefill":
        cache = rmodel.make_cache(cfg, B, S)
        jax.eval_shape(lambda p, c: rmodel.prefill(
            p, jnp.asarray(toks), c, cfg, positions=None if pos is None
            else jnp.asarray(pos), extra_embeds=None if extra is None else
            jnp.asarray(extra), shard=rec), pshape, cache)
    else:
        cache = rmodel.make_cache(cfg, B, S + 1)
        jax.eval_shape(lambda p, c: rmodel.decode_step(
            p, jnp.asarray(tok1), c, jnp.int32(S), cfg, shard=rec),
            pshape, cache)
    return calls


def _port_calls(arch: str, fn: str):
    cfg = tconfigs.smoke_config(arch)
    model = tmodel.init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    toks, extra, pos, tok1 = _inputs(cfg)
    calls = []

    def rec(x, kind):
        calls.append((kind, tuple(x.shape)))
        return x

    toks = torch.tensor(toks)
    extra = None if extra is None else torch.tensor(extra)
    pos = None if pos is None else torch.tensor(pos)
    with torch.no_grad():
        if fn == "forward":
            tmodel.forward(model, toks, cfg, positions=pos,
                           extra_embeds=extra, shard=rec)
        elif fn == "prefill":
            cache = tmodel.make_cache(cfg, B, S, concrete=True,
                                      device="cpu")
            tmodel.prefill(model, toks, cache, cfg, positions=pos,
                           extra_embeds=extra, shard=rec)
        else:
            cache = tmodel.make_cache(cfg, B, S + 1, concrete=True,
                                      device="cpu")
            tmodel.decode_step(model, torch.tensor(tok1), cache, S, cfg,
                               shard=rec)
    return calls


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_shard_call_sites(arch, fn):
    want = _ref_calls(arch, fn)
    got = _port_calls(arch, fn)
    assert {k for k, _ in want} >= {"resid"}
    assert got == want


def test_id_shard_changes_nothing():
    """A callback that returns its tensor (the port's ``make_shard_fn``)
    leaves the forward bitwise the default's."""
    cfg = tconfigs.smoke_config("zamba2-7b")
    model = tmodel.init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    toks = torch.tensor(_inputs(cfg)[0])
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    shard = trules.make_shard_fn(mesh, trules.ExecConfig(), B)
    specs = []

    def rec(x, kind):
        specs.append(shard.spec(x, kind))
        return shard(x, kind)

    with torch.no_grad():
        want, _ = tmodel.forward(model, toks, cfg)
        got, _ = tmodel.forward(model, toks, cfg, shard=rec)
    assert torch.equal(got, want)
    assert len(specs) > cfg.num_layers and all(specs)


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StubMesh:
    """What the rules read of a mesh: its ``shape``."""
    axes: tuple

    @property
    def shape(self) -> dict:
        return dict(self.axes)


STUBS = [StubMesh((("data", 2), ("model", 4))),
         StubMesh((("data", 16), ("model", 16))),
         StubMesh((("pod", 2), ("data", 16), ("model", 16)))]
MAX_LEN = 4096


@functools.lru_cache(maxsize=None)
def _ref_cache(arch: str, batch: int):
    return rmodel.make_cache(rconfigs.get(arch), batch, MAX_LEN)


@pytest.mark.parametrize("batch", [32, 1])
@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_cache_specs(arch, batch):
    rcfg, tcfg = rconfigs.get(arch), tconfigs.get(arch)
    rcache = _ref_cache(arch, batch)
    tcache = tmodel.make_cache(tcfg, batch, MAX_LEN)
    for mesh in STUBS:
        want = rrules.cache_specs(rcache, rcfg, mesh, batch)
        got = trules.cache_specs(tcache, tcfg, mesh, batch)
        assert len(got["layers"]) == rcfg.num_layers
        for seg, specs, shapes in zip(segments(rcfg), want["segments"],
                                      rcache["segments"]):
            for ki, kind in enumerate(seg.kinds):
                for leaf, spec in specs[f"{ki}_{kind}"].items():
                    rank = len(shapes[f"{ki}_{kind}"][leaf].shape)
                    inner = _norm(spec, rank)
                    assert inner[0] is None
                    for r in range(seg.repeats):
                        layer = seg.start_layer + r * len(seg.kinds) + ki
                        t = tcache["layers"][layer][leaf]
                        assert t.device.type == "meta"
                        assert _norm(got["layers"][layer][leaf],
                                     rank - 1) == inner[1:], \
                            (mesh, layer, leaf)
