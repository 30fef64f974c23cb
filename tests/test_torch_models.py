"""The port's model zoo serving path (``repro_torch.models`` and
``repro_torch.configs``) against the reference's ``repro.models`` and
``repro.configs`` on the same numpy-seeded inputs, in float32 at the
``SMOKE`` sizes, with the reference's weights carried across by
``params_from_reference`` (``device="cpu"``: K9 and K10 run their plain
versions, and no kernel launches).

Tolerances (float32; both sides do the same products, summed in another
order, and K9 and K10's plain versions take the online softmax and the
chunked scan where the reference takes einsums):

* logits and block outputs within LOGIT_TOL = 1e-4 absolute (|logits|
  <= ~1 at these sizes);
* caches (K/V, MLA's latents, the conv window, the float32 SSM state,
  sLSTM's h) within CACHE_TOL = 5e-5 absolute; sLSTM's c, n and m
  within CACHE_TOL relative besides (SLSTM_GROWING): m is a running sum
  of raw forget pre-activations (~20 after 37 steps of the SMOKE model),
  and e^(i - m) turns m's absolute rounding into relative error in n
  and c, so the last layer inherits the layers' float32 noise (~1e-6
  relative a layer) amplified;
* the MoE router's aux loss (summed over the layers) within LAYER_TOL;
* single layers (norms, rotary embeddings, MLPs, embeddings) within
  LAYER_TOL = 1e-5;
* the GLA core within the reference's kernel tolerance, rtol 1e-4 and
  atol 1e-5 (``tests/test_kernels.py``).
"""

import _torch_threads  # noqa: F401  (an xdist worker's share of the threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro.models import ssm as rssm
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.kernels.attention import kernel as k9
from repro_torch.kernels.gla import kernel as k10
from repro_torch.kernels.slstm import kernel as kslstm
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm

LOGIT_TOL = 1e-4
CACHE_TOL = 5e-5
#: sLSTM's states that grow with S (see above).
SLSTM_GROWING = ("c", "n", "m")
LAYER_TOL = 1e-5
GLA_RTOL, GLA_ATOL = 1e-4, 1e-5

#: The archs the port serves: all ten.
SLICE = ("granite-20b", "minitron-4b", "phi3-mini-3p8b", "starcoder2-15b",
         "musicgen-large", "qwen2-vl-2b", "zamba2-7b", "deepseek-v2-236b",
         "kimi-k2-1t-a32b", "xlstm-1p3b")

_ref_init = jax.jit(rmodel.init, static_argnums=(1,))
_ref_forward = jax.jit(rmodel.forward, static_argnums=(2,))
_ref_prefill = jax.jit(rmodel.prefill, static_argnums=(3,))
_ref_decode = jax.jit(rmodel.decode_step, static_argnums=(4,))
_ref_gqa = jax.jit(rattn.gqa_apply, static_argnums=(2,))
_ref_mla = jax.jit(rattn.mla_apply, static_argnums=(2,))
_ref_mamba2 = jax.jit(rssm.mamba2_apply, static_argnums=(2,))
_ref_mlstm = jax.jit(rssm.mlstm_apply, static_argnums=(2,))
_ref_slstm = jax.jit(rssm.slstm_apply, static_argnums=(2,))
_ref_loss = jax.jit(rmodel.loss_fn, static_argnums=(2,))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _load(module: torch.nn.Module, tree) -> torch.nn.Module:
    """``module`` holding the reference's parameter ``tree``."""
    flat = {}
    tmodel._flatten(tree, "", flat)
    module.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in flat.items()}, strict=True)
    return module


def _gen():
    return torch.Generator().manual_seed(0)


def _unlaunched():
    """K9's, K10's and the sLSTM scan's launch counts (none may move on
    the CPU)."""
    return (k9.LIB.launches, k9.BF16_LIB.launches, k10.LIB.launches,
            kslstm.LIB.launches)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_configs_equal_reference(arch):
    """CONFIG, SMOKE and every EXEC entry equal the reference's, field for
    field; ``exec_default`` and ``canonical`` agree."""
    assert tconfigs.ARCHS == rconfigs.ARCHS
    asdict = dataclasses.asdict
    assert asdict(tconfigs.get(arch)) == asdict(rconfigs.get(arch))
    assert asdict(tconfigs.smoke_config(arch)) == \
        asdict(rconfigs.smoke_config(arch))
    mod = arch.replace("-", "_")
    rexec = __import__(f"repro.configs.{mod}", fromlist=["EXEC"]).EXEC
    texec = tconfigs._module(arch).EXEC
    assert {k: v.as_dict() for k, v in texec.items()} == \
        {k: v.as_dict() for k, v in rexec.items()}
    for shape in rconfigs.SHAPES:
        assert tconfigs.exec_default(arch, shape).as_dict() == \
            rconfigs.exec_default(arch, shape).as_dict()


def test_shapes_cells_and_aliases():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    assert tconfigs.LONG_CTX_ARCHS == rconfigs.LONG_CTX_ARCHS
    assert tconfigs.cells() == rconfigs.cells()
    assert tconfigs.cells(include_skipped=True) == \
        rconfigs.cells(include_skipped=True)
    assert tconfigs.canonical("xlstm-1.3b") == "xlstm-1p3b"
    assert tconfigs.get("phi3-mini-3.8b").name == "phi3-mini-3p8b"


def test_exec_config_round_trip():
    from repro.sharding.rules import ExecConfig as RExec
    from repro_torch.sharding.rules import ExecConfig
    e = ExecConfig(remat="full", microbatch=4, moe_expert_tp=True)
    assert ExecConfig.from_dict({**e.as_dict(), "unknown": 1}) == e
    assert e.as_dict() == RExec(remat="full", microbatch=4,
                                moe_expert_tp=True).as_dict()


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_segments_equal_reference(arch):
    for cfg in (tconfigs.get(arch), tconfigs.smoke_config(arch)):
        rcfg = rconfigs.get(arch) if cfg.name == rconfigs.get(arch).name \
            else rconfigs.smoke_config(arch)
        got = [dataclasses.astuple(s) for s in tmodels.segments(cfg)]
        want = [dataclasses.astuple(s) for s in rmodel.segments(rcfg)]
        assert got == want
        assert cfg.layer_kinds() == rcfg.layer_kinds()


def test_unknown_kind_raises():
    """A block kind the port does not know raises ``ValueError``, as the
    reference's ``_block_init`` does."""
    cfg = dataclasses.replace(tconfigs.smoke_config("xlstm-1p3b"),
                              block_pattern=("mlstm", "lstm"))
    with pytest.raises(ValueError, match="unknown block kind lstm"):
        tmodels.init(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown block kind"):
        rmodel.init(jax.random.PRNGKey(0), dataclasses.replace(
            rconfigs.smoke_config("xlstm-1p3b"),
            block_pattern=("mlstm", "lstm")))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp(act):
    """gelu (the tanh approximation, jax's default) and swiglu."""
    cfg = dataclasses.replace(tconfigs.smoke_config("granite-20b"), act=act)
    p = rlayers.mlp_init(jax.random.PRNGKey(3), cfg)
    mod = _load(tlayers.MLP(cfg, generator=_gen(), device="cpu"), p)
    assert hasattr(mod, "w_gate") == (act == "swiglu")
    x = _x(np.random.default_rng(1), 2, 5, cfg.d_model)
    _close(mod(torch.tensor(x), cfg), rlayers.mlp(p, jnp.asarray(x), cfg),
           LAYER_TOL)


def test_rmsnorm_dense_and_softplus():
    rng = np.random.default_rng(2)
    x, scale = _x(rng, 3, 4, 32), _x(rng, 32)
    _close(tlayers.rmsnorm(torch.tensor(scale), torch.tensor(x), 1e-5),
           rlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           LAYER_TOL)
    w = _x(rng, 32, 8)
    _close(tlayers.dense(torch.tensor(w), torch.tensor(x)),
           rlayers.dense({"w": jnp.asarray(w)}, jnp.asarray(x)), LAYER_TOL)
    # jax.nn.softplus is log(1 + e^x) above F.softplus's threshold too
    z = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_array_equal(_np(tssm._softplus(torch.tensor(z))),
                                  np.asarray(jax.nn.softplus(z)))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(theta):
    rng = np.random.default_rng(4)
    x = _x(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    _close(tlayers.rope(torch.tensor(x), torch.tensor(pos), theta),
           rlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta), LAYER_TOL)


def test_mrope():
    """positions [3, B, S]: one stream a section."""
    rng = np.random.default_rng(5)
    x = _x(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 50, size=(3, 2, 7)).astype(np.int32)
    _close(tlayers.mrope(torch.tensor(x), torch.tensor(pos), (2, 3, 3)),
           rlayers.mrope(jnp.asarray(x), jnp.asarray(pos), (2, 3, 3)),
           LAYER_TOL)
    with pytest.raises(ValueError, match="sections"):
        tlayers.mrope(torch.tensor(x), torch.tensor(pos), (2, 3, 2))


@pytest.mark.parametrize("tied", [False, True])
def test_codebook_embed_and_unembed(tied):
    """musicgen's four codebooks summed at the embedding (per-codebook
    offsets), and the unembedding tied to the table or not."""
    cfg = dataclasses.replace(tconfigs.smoke_config("musicgen-large"),
                              tie_embeddings=tied)
    p = rlayers.embed_init(jax.random.PRNGKey(6), cfg)
    mod = _load(tlayers.Embedding(cfg, generator=_gen(), device="cpu"), p)
    assert hasattr(mod, "unembed") == (not tied)
    rng = np.random.default_rng(6)
    tok = rng.integers(0, cfg.vocab_size, size=(2, 5, 4)).astype(np.int32)
    _close(tlayers.embed(mod, torch.tensor(tok), cfg),
           rlayers.embed(p, jnp.asarray(tok), cfg), LAYER_TOL)
    _close(tlayers.embed(mod, torch.tensor(tok[..., 0]), cfg),
           rlayers.embed(p, jnp.asarray(tok[..., 0]), cfg), 0.0)
    x = _x(rng, 2, 5, cfg.d_model)
    _close(tlayers.unembed(mod, torch.tensor(x), cfg),
           rlayers.unembed(p, jnp.asarray(x), cfg), LAYER_TOL)


def test_cross_entropy():
    rng = np.random.default_rng(7)
    logits = _x(rng, 2, 5, 4, 11)
    labels = rng.integers(0, 11, size=(2, 5, 4)).astype(np.int32)
    mask = (rng.random((2, 5, 4)) > 0.3).astype(np.float32)
    for m in (None, mask):
        _close(tlayers.cross_entropy(torch.tensor(logits),
                                     torch.tensor(labels),
                                     None if m is None else torch.tensor(m)),
               rlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m)),
               LAYER_TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _gqa(arch, **over):
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), **over)
    p = rattn.gqa_init(jax.random.PRNGKey(8), cfg)
    mod = _load(tattn.GQAttention(cfg, generator=_gen(), device="cpu"), p)
    return cfg, p, mod


def _positions(cfg, rng, B, S, offset=0):
    pos = np.broadcast_to(np.arange(S) + offset, (B, S)).astype(np.int32)
    if cfg.rope_kind == "mrope":
        return np.stack([pos, pos + rng.integers(0, 4, (B, S)),
                         pos + rng.integers(0, 4, (B, S))]).astype(np.int32)
    return pos


@pytest.mark.parametrize("arch,S,over", [
    ("minitron-4b", 100, {}),       # G = 3, S not a multiple of 64
    ("granite-20b", 64, {}),        # MQA, S a multiple of 64
    ("qwen2-vl-2b", 37, {}),        # M-RoPE
    # the reference's blockwise online softmax, K9 in the port
    ("minitron-4b", 100, dict(blockwise_attn_threshold=32, attn_block_q=16,
                              attn_block_kv=32)),
])
def test_gqa_without_cache(arch, S, over):
    cfg, p, mod = _gqa(arch, **over)
    rng = np.random.default_rng(S)
    x = _x(rng, 2, S, cfg.d_model)
    pos = _positions(cfg, rng, 2, S)
    before = _unlaunched()
    out, cache = mod(torch.tensor(x), cfg, torch.tensor(pos))
    ref, _ = _ref_gqa(p, jnp.asarray(x), cfg, jnp.asarray(pos))
    assert cache is None and _unlaunched() == before
    _close(out, ref, LOGIT_TOL)


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2-vl-2b"])
def test_gqa_with_cache(arch):
    """A prefill at cache_pos 0 (K9's route), a decode step at S = 1 and
    a chunked prefill at cache_pos > 0 (plain attention over the
    cache): outputs and the K/V cache after each."""
    cfg, p, mod = _gqa(arch)
    rng = np.random.default_rng(9)
    B, max_len = 2, 56
    shape = (B, max_len, cfg.num_kv_heads, cfg.head_dim)
    rc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {n: torch.zeros(shape) for n in ("k", "v")}
    pos0 = 0
    for S in (37, 1, 5, 1):
        x = _x(rng, B, S, cfg.d_model)
        pos = _positions(cfg, rng, B, S, pos0)
        ref, rc = _ref_gqa(p, jnp.asarray(x), cfg, jnp.asarray(pos), rc,
                           pos0)
        out, tc = mod(torch.tensor(x), cfg, torch.tensor(pos), tc, pos0)
        _close(out, ref, LOGIT_TOL)
        for n in ("k", "v"):
            _close(tc[n], rc[n], CACHE_TOL)
        pos0 += S


def _mla(arch, **over):
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), **over)
    p = rattn.mla_init(jax.random.PRNGKey(10), cfg)
    mod = _load(tattn.MLAttention(cfg, generator=_gen(), device="cpu"), p)
    return cfg, p, mod


@pytest.mark.parametrize("arch,over", [
    ("deepseek-v2-236b", {}),
    ("kimi-k2-1t-a32b", {}),
    ("deepseek-v2-236b", dict(q_lora_rank=0)),     # wq, no q compression
])
def test_mla_without_cache(arch, over):
    """MLA's prefill without a cache: K9's route (its plain version here,
    q and k dn + dr = 24 wide, v 16), S ragged against K9's 64."""
    cfg, p, mod = _mla(arch, **over)
    assert hasattr(mod, "wq") == (cfg.q_lora_rank == 0)
    rng = np.random.default_rng(15)
    x = _x(rng, 2, 37, cfg.d_model)
    pos = _positions(cfg, rng, 2, 37)
    before = _unlaunched()
    out, cache = mod(torch.tensor(x), cfg, torch.tensor(pos))
    ref, _ = _ref_mla(p, jnp.asarray(x), cfg, jnp.asarray(pos))
    assert cache is None and _unlaunched() == before
    _close(out, ref, LOGIT_TOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_mla_with_cache(arch):
    """A prefill at cache_pos 0 (K9's route), the absorbed decode (S =
    1 over the latent cache), a multi-token call at cache_pos > 0 (plain
    attention over the decompressed prefix) and another decode step:
    outputs and the latent cache after each."""
    cfg, p, mod = _mla(arch)
    rng = np.random.default_rng(16)
    B, max_len = 2, 56
    spec = rattn.mla_cache_spec(cfg, B, max_len)
    tspec = tattn.MLAttention.cache_spec(cfg, B, max_len)
    assert {n: (tuple(s.shape), str(s.dtype)) for n, s in spec.items()} == \
        {n: (shape, str(dt)[6:]) for n, (shape, dt) in tspec.items()}
    rc = {n: jnp.zeros(s.shape, s.dtype) for n, s in spec.items()}
    tc = {n: torch.zeros(shape, dtype=dt) for n, (shape, dt) in tspec.items()}
    pos0 = 0
    for S in (37, 1, 5, 1):
        x = _x(rng, B, S, cfg.d_model)
        pos = _positions(cfg, rng, B, S, pos0)
        ref, rc = _ref_mla(p, jnp.asarray(x), cfg, jnp.asarray(pos), rc,
                           pos0)
        out, tc = mod(torch.tensor(x), cfg, torch.tensor(pos), tc, pos0)
        _close(out, ref, LOGIT_TOL)
        for n in ("c_kv", "k_rope"):
            _close(tc[n], rc[n], CACHE_TOL)
        pos0 += S


# ---------------------------------------------------------------------------
# ssm
# ---------------------------------------------------------------------------

def _gla_inputs(rng, B, H, S, dk, dv):
    return (_x(rng, B, H, S, dk), (0.3 * _x(rng, B, H, S, dk)),
            _x(rng, B, H, S, dv),
            -np.abs(0.2 * _x(rng, B, H, S)).astype(np.float32))


@pytest.mark.parametrize("S,chunk,with_state", [
    (45, 16, True), (45, 16, False), (10, 16, True), (64, 16, True)])
def test_gla_chunked(S, chunk, with_state):
    """S ragged against the chunk (and below it), with and without a
    non-zero initial state."""
    rng = np.random.default_rng(S + chunk)
    q, k, v, la = _gla_inputs(rng, 2, 3, S, 8, 4)
    s0 = _x(rng, 2, 3, 8, 4) if with_state else None
    before = _unlaunched()
    o, st = tssm.gla_chunked(*map(torch.tensor, (q, k, v, la)), chunk,
                             None if s0 is None else torch.tensor(s0))
    assert _unlaunched() == before
    ro, rs = rssm.gla_chunked(*map(jnp.asarray, (q, k, v, la)), chunk,
                              None if s0 is None else jnp.asarray(s0))
    _close(o, ro, GLA_ATOL, GLA_RTOL)
    _close(st, rs, GLA_ATOL, GLA_RTOL)


def test_gla_step():
    rng = np.random.default_rng(11)
    q, k, v = _x(rng, 2, 3, 8), _x(rng, 2, 3, 8), _x(rng, 2, 3, 4)
    la = -np.abs(_x(rng, 2, 3))
    st = _x(rng, 2, 3, 8, 4)
    o, s = tssm.gla_step(*map(torch.tensor, (q, k, v, la, st)))
    ro, rs = rssm.gla_step(*map(jnp.asarray, (q, k, v, la, st)))
    _close(o, ro, LAYER_TOL)
    _close(s, rs, LAYER_TOL)


def test_mamba2():
    """zamba2's mixer with no state (forward), a prefill from an empty
    state (S = 37, ragged against chunk 16), a decode step and a chunked
    prefill from the state it left."""
    cfg = tconfigs.smoke_config("zamba2-7b")
    p = rssm.mamba2_init(jax.random.PRNGKey(12), cfg)
    # non-trivial A_log, dt_bias and D (the init's are 0, 0, 1)
    rng = np.random.default_rng(12)
    H = p["A_log"].shape[0]
    p = {**p, "A_log": jnp.asarray(_x(rng, H) * 0.5),
         "dt_bias": jnp.asarray(_x(rng, H) * 0.5),
         "D": jnp.asarray(_x(rng, H))}
    mod = _load(tssm.Mamba2(cfg, generator=_gen(), device="cpu"), p)
    x = _x(rng, 2, 37, cfg.d_model)
    out, st = mod(torch.tensor(x), cfg)
    ref, _ = _ref_mamba2(p, jnp.asarray(x), cfg)
    assert st is None
    _close(out, ref, LOGIT_TOL)
    spec = rssm.mamba2_state_spec(cfg, 2)
    tspec = tssm.Mamba2.state_spec(cfg, 2)
    assert {n: (tuple(s.shape), str(s.dtype)) for n, s in spec.items()} == \
        {n: (shape, str(dt)[6:]) for n, (shape, dt) in tspec.items()}
    rs = {n: jnp.zeros(s.shape, s.dtype) for n, s in spec.items()}
    ts = {n: torch.zeros(shape, dtype=dt) for n, (shape, dt) in tspec.items()}
    for S in (37, 1, 6):
        x = _x(rng, 2, S, cfg.d_model)
        ref, rs = _ref_mamba2(p, jnp.asarray(x), cfg, rs)
        out, ts = mod(torch.tensor(x), cfg, ts)
        _close(out, ref, LOGIT_TOL)
        for n in ("conv", "ssm"):
            _close(ts[n], rs[n], CACHE_TOL)


def _xlstm_cfg(wide: bool):
    """xLSTM's SMOKE config (dh 32), or widened to d_model 256 over 2
    heads (dh 256: K10's blocked route, two dk blocks and two dv
    blocks)."""
    over = dict(d_model=256, num_heads=2, num_kv_heads=2) if wide else {}
    return (dataclasses.replace(rconfigs.smoke_config("xlstm-1p3b"), **over),
            dataclasses.replace(tconfigs.smoke_config("xlstm-1p3b"), **over))


def _state_pair(spec, tspec):
    assert {n: (tuple(s.shape), str(s.dtype)) for n, s in spec.items()} == \
        {n: (shape, str(dt)[6:]) for n, (shape, dt) in tspec.items()}
    return ({n: jnp.zeros(s.shape, s.dtype) for n, s in spec.items()},
            {n: torch.zeros(shape, dtype=dt)
             for n, (shape, dt) in tspec.items()})


@pytest.mark.parametrize("wide", [False, True])
def test_mlstm(wide):
    """The mLSTM mixer with no state (forward: two scans), a prefill from
    an empty state (S = 37, ragged against chunk 16), a decode step
    (``gla_step`` on the state's numerator and normalizer columns) and
    a chunked prefill from the state it left; at dh 256 the scans take
    K10's blocked route."""
    rcfg, cfg = _xlstm_cfg(wide)
    p = rssm.mlstm_init(jax.random.PRNGKey(18), rcfg)
    rng = np.random.default_rng(18)
    # gates away from the init's zero bias: input gates and forget decays
    # spread over (0, 1)
    H = rcfg.num_heads
    w = np.asarray(p["w_gates"]["w"])
    p = {**p, "w_gates": {"w": jnp.asarray(w * 4.0)},
         "conv_b": jnp.asarray(_x(rng, p["conv_b"].shape[0]) * 0.1)}
    mod = _load(tssm.MLSTM(cfg, generator=_gen(), device="cpu"), p)
    x = _x(rng, 2, 37, cfg.d_model)
    before = _unlaunched()
    out, st = mod(torch.tensor(x), cfg)
    ref, _ = _ref_mlstm(p, jnp.asarray(x), rcfg)
    assert st is None
    _close(out, ref, LAYER_TOL)
    rs, ts = _state_pair(rssm.mlstm_state_spec(rcfg, 2),
                         tssm.MLSTM.state_spec(cfg, 2))
    dh = 2 * cfg.d_model // H
    assert ts["ssm"].shape == (2, H, dh, dh + 1)
    for S in (37, 1, 6):
        x = _x(rng, 2, S, cfg.d_model)
        ref, rs = _ref_mlstm(p, jnp.asarray(x), rcfg, rs)
        out, ts = mod(torch.tensor(x), cfg, ts)
        _close(out, ref, LAYER_TOL)
        for n in ("conv", "ssm"):
            _close(ts[n], rs[n], CACHE_TOL)
    assert _unlaunched() == before


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("S,with_state", [(37, False), (37, True),
                                          (1, True)])
def test_mlstm_one_scan(wide, S, with_state):
    """``mlstm_scan``, the numerator and normalizer as one scan of dh + 1
    value columns (at dh 256 on K10's blocked route, 3 value blocks),
    against the two scans the reference's ``mlstm_apply`` runs: its
    ``gla_chunked`` (or, at S = 1, ``gla_step``) of v i_g and of i_g,
    each from its own columns of the state, and against the port's two
    scans the same way.  Outputs within LOGIT_TOL, the state within
    CACHE_TOL (the whole layer against ``mlstm_apply``: test_mlstm)."""
    _, cfg = _xlstm_cfg(wide)
    H = cfg.num_heads
    dh = cfg.ssm_expand * cfg.d_model // H
    rng = np.random.default_rng(20 + S + 2 * wide + with_state)
    q, k, v = (_x(rng, 2, H, S, dh) * dh ** -0.5 for _ in range(3))
    i_g = 1.0 / (1.0 + np.exp(-_x(rng, 2, H, S)))
    log_f = -np.log1p(np.exp(-4.0 * _x(rng, 2, H, S)))
    log_f = log_f.astype(np.float32)
    i_g = i_g.astype(np.float32)
    ssm = _x(rng, 2, H, dh, dh + 1) if with_state else None
    t = lambda a: None if a is None else torch.tensor(a)
    o_num, o_den, new = tssm.mlstm_scan(t(q), t(k), t(v), t(i_g), t(log_f),
                                        cfg.gla_chunk, t(ssm))
    assert o_num.shape == (2, H, S, dh) and o_den.shape == (2, H, S)
    assert (new is None) == (ssm is None)
    v_num, v_den = v * i_g[..., None], i_g[..., None]
    for lib, arr in ((rssm, jnp.asarray), (tssm, torch.tensor)):
        outs = []
        for vv, sl in ((v_num, np.s_[..., :dh]), (v_den, np.s_[..., dh:])):
            st = None if ssm is None else arr(np.ascontiguousarray(ssm[sl]))
            if S == 1:
                o, fin = lib.gla_step(arr(q[:, :, 0]), arr(k[:, :, 0]),
                                      arr(vv[:, :, 0]), arr(log_f[..., 0]),
                                      st)
                o = np.asarray(o)[:, :, None]
            else:
                o, fin = lib.gla_chunked(
                    *map(arr, (q, k, vv, log_f)), cfg.gla_chunk,
                    **({} if st is None else {"initial_state": st}))
            outs.append((np.asarray(o), np.asarray(fin)))
        (on, fn), (od, fd) = outs
        _close(o_num, on, LOGIT_TOL)
        _close(o_den, od[..., 0], LOGIT_TOL)
        if ssm is not None:
            _close(new, np.concatenate([fn, fd], axis=-1), CACHE_TOL)


@pytest.mark.parametrize("S", [1, 37, 256])
def test_slstm(S):
    """The sLSTM mixer with no state and from a non-zero state (its
    output and h, c, n, m); at S = 256 the reference takes its chunked
    branch (two checkpointed 128-step scans)."""
    rcfg, cfg = _xlstm_cfg(False)
    p = rssm.slstm_init(jax.random.PRNGKey(19), rcfg)
    rng = np.random.default_rng(19 + S)
    D = cfg.d_model
    p = {**p, "r": jnp.asarray(_x(rng, 4, D) * 0.5)}
    mod = _load(tssm.SLSTM(cfg, generator=_gen(), device="cpu"), p)
    x = _x(rng, 2, S, D)
    before = _unlaunched()
    out, st = mod(torch.tensor(x), cfg)
    ref, _ = _ref_slstm(p, jnp.asarray(x), rcfg)
    assert st is None
    _close(out, ref, LAYER_TOL)
    rs, ts = _state_pair(rssm.slstm_state_spec(rcfg, 2),
                         tssm.SLSTM.state_spec(cfg, 2))
    start = {n: _x(rng, 2, D) for n in "hcnm"}
    start["n"] = np.abs(start["n"]) + 0.5
    rs = {n: jnp.asarray(a) for n, a in start.items()}
    ts = {n: torch.tensor(a) for n, a in start.items()}
    ref, rs = _ref_slstm(p, jnp.asarray(x), rcfg, rs)
    out, ts = mod(torch.tensor(x), cfg, ts)
    _close(out, ref, LAYER_TOL)
    for n in "hcnm":
        _close(ts[n], rs[n], CACHE_TOL)
    assert _unlaunched() == before


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _inputs(cfg, rng, B, S):
    shape = (B, S) if cfg.num_codebooks == 1 else (B, S, cfg.num_codebooks)
    toks = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    kw = {}
    if cfg.frontend == "vision":
        kw = dict(extra_embeds=_x(rng, B, S, cfg.d_model),
                  positions=_positions(cfg, rng, B, S))
    return toks, kw


B, S, STEPS = 2, 37, 4


@pytest.fixture(scope="module", params=SLICE)
def run(request):
    """One arch's reference run at its SMOKE size: forward logits, the
    prefill's logits and cache, and 4 greedy decode steps (the
    reference's tokens), beside the port built from the same weights."""
    arch = request.param
    cfg = rconfigs.smoke_config(arch)
    params = _ref_init(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(13)
    toks, kw = _inputs(cfg, rng, B, S)
    jkw = {n: jnp.asarray(a) for n, a in kw.items()}
    logits, aux = _ref_forward(params, jnp.asarray(toks), cfg, **jkw)
    cache = rmodel.make_cache(cfg, B, S + STEPS, concrete=True)
    last, cache = _ref_prefill(params, jnp.asarray(toks), cache, cfg, **jkw)
    prefill_cache = jax.tree.map(np.asarray, cache)
    steps, tok = [], np.asarray(last)
    for i in range(STEPS):
        tok = tok.reshape(B, -1, cfg.vocab_size).argmax(-1).astype(np.int32)
        tok = tok[:, 0] if cfg.num_codebooks == 1 else tok
        step_logits, cache = _ref_decode(params, jnp.asarray(tok), cache,
                                         jnp.int32(S + i), cfg)
        steps.append((tok, np.asarray(step_logits)))
        tok = np.asarray(step_logits)
    tcfg = tconfigs.smoke_config(arch)
    model = tmodel.params_from_reference(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return dict(arch=arch, cfg=tcfg, params=params, model=model, toks=toks,
                kw=kw, logits=np.asarray(logits), aux=float(aux),
                last=np.asarray(last),
                prefill_cache=prefill_cache, steps=steps,
                final_cache=jax.tree.map(np.asarray, cache))


def _check_cache(cfg, got, ref_cache):
    layers = tmodel.unstack_segments(ref_cache["segments"], cfg)
    assert len(got["layers"]) == len(layers) == cfg.num_layers
    for i, want in enumerate(layers):
        assert set(got["layers"][i]) == set(want)
        for n in want:
            assert got["layers"][i][n].dtype == \
                torch.from_numpy(np.zeros(1, want[n].dtype)).dtype
            _close(got["layers"][i][n], want[n], CACHE_TOL,
                   CACHE_TOL if n in SLSTM_GROWING else 0.0)


def test_weights_carried_across(run):
    """``params_from_reference`` carries every leaf: the port's parameter
    count is the reference's, and each layer's weights are the
    reference's stacked slice."""
    model, params, cfg = run["model"], run["params"], run["cfg"]
    assert tmodels.param_count(model) == rmodel.param_count(params)
    assert tmodels.active_param_count(model, cfg) == \
        rmodel.active_param_count(params, rconfigs.smoke_config(run["arch"]))
    layers = tmodel.unstack_segments(
        jax.tree.map(np.asarray, params["segments"]), cfg)
    sd = model.state_dict()
    for i, tree in enumerate(layers):
        flat = {}
        tmodel._flatten(tree, f"layers.{i}.", flat)
        for name, leaf in flat.items():
            np.testing.assert_array_equal(sd[name].numpy(), leaf)
    if "shared_attn" in params:
        np.testing.assert_array_equal(
            sd["shared_attn.attn.wq.w"].numpy(),
            np.asarray(params["shared_attn"]["attn"]["wq"]["w"]))


def test_forward(run):
    """Logits, and the aux loss: the MoE layers' router losses summed (0
    without experts)."""
    cfg = run["cfg"]
    before = _unlaunched()
    logits, aux = tmodels.forward(run["model"], torch.tensor(run["toks"]),
                                  cfg, **{n: torch.tensor(a) for n, a in
                                          run["kw"].items()})
    assert _unlaunched() == before
    assert logits.shape == run["logits"].shape and aux.dtype == torch.float32
    assert (float(aux) == 0.0) == (not cfg.is_moe) == (run["aux"] == 0.0)
    _close(aux, run["aux"], LAYER_TOL)
    _close(logits, run["logits"], LOGIT_TOL)


def test_prefill_and_cache(run):
    """The prefill's last logits and every layer's cache; the last
    logits are also the forward pass's at S - 1."""
    cfg = run["cfg"]
    cache = tmodels.make_cache(cfg, B, S + STEPS, concrete=True,
                               device="cpu")
    last, cache = tmodels.prefill(run["model"], torch.tensor(run["toks"]),
                                  cache, cfg, **{n: torch.tensor(a) for n, a
                                                 in run["kw"].items()})
    _close(last, run["last"], LOGIT_TOL)
    _close(last, run["logits"][:, -1], LOGIT_TOL)
    _check_cache(cfg, cache, run["prefill_cache"])


def test_decode_steps(run):
    """4 decode steps from the prefill's cache, fed the reference's greedy
    tokens: each step's logits and the cache after the last."""
    cfg, model = run["cfg"], run["model"]
    cache = tmodels.make_cache(cfg, B, S + STEPS, concrete=True,
                               device="cpu")
    _, cache = tmodels.prefill(model, torch.tensor(run["toks"]), cache, cfg,
                               **{n: torch.tensor(a) for n, a in
                                  run["kw"].items()})
    before = _unlaunched()
    for i, (tok, want) in enumerate(run["steps"]):
        logits, cache = tmodels.decode_step(model, torch.tensor(tok), cache,
                                            S + i, cfg)
        _close(logits, want, LOGIT_TOL)
    assert _unlaunched() == before
    _check_cache(cfg, cache, run["final_cache"])


def test_make_cache_spec(run):
    """Shapes and dtypes of ``make_cache``: stand-ins on the meta device,
    and zeros on the CPU, layer for layer the reference's stacked
    ShapeDtypeStructs."""
    cfg = run["cfg"]
    spec = rmodel.make_cache(rconfigs.smoke_config(run["arch"]), 3, 19)
    want = tmodel.unstack_segments(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), spec)["segments"], cfg)
    want = [{n: (a.shape, str(a.dtype)) for n, a in layer.items()}
            for layer in want]
    for concrete in (False, True):
        cache = tmodels.make_cache(cfg, 3, 19, concrete=concrete,
                                   device="cpu")
        got = [{n: (tuple(t.shape), str(t.dtype)[6:])
                for n, t in layer.items()} for layer in cache["layers"]]
        assert got == want
        dev = {t.device.type for layer in cache["layers"]
               for t in layer.values()}
        assert dev == {"cpu" if concrete else "meta"}


@pytest.mark.parametrize("arch", ["musicgen-large", "granite-20b",
                                  "deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_loss_fn(arch):
    """The scoring loss (one codebook and four, with a mask; with the MoE
    router's aux loss weighted in)."""
    cfg = rconfigs.smoke_config(arch)
    params = _ref_init(jax.random.PRNGKey(2), cfg)
    model = tmodel.params_from_reference(jax.tree.map(np.asarray, params),
                                         tconfigs.smoke_config(arch),
                                         device="cpu")
    rng = np.random.default_rng(14)
    toks, _ = _inputs(cfg, rng, 2, 9)
    labels, _ = _inputs(cfg, rng, 2, 9)
    mask = (rng.random(labels.shape) > 0.3).astype(np.float32)
    batch = {"tokens": toks, "labels": labels, "mask": mask}
    rl, raux = _ref_loss(params, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, cfg)
    tl, taux = tmodels.loss_fn(model, {k: torch.tensor(v) for k, v in
                                       batch.items()},
                               tconfigs.smoke_config(arch))
    _close(tl, rl, LAYER_TOL)
    _close(taux["ce"], raux["ce"], LAYER_TOL)
    _close(taux["aux"], raux["aux"], LAYER_TOL)


@pytest.mark.parametrize("capacity_factor", [0.05, 4.0])
def test_forward_under_the_callers_config(capacity_factor):
    """``forward`` runs the layers under the config it is given, as the
    reference does: the weights do not fix the MoE capacity factor, so a
    tight one (assignments dropped) and a dropless one (C = T) each give
    the reference's logits and aux on the same weights."""
    arch = "deepseek-v2-236b"
    rcfg = dataclasses.replace(rconfigs.smoke_config(arch),
                               capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch),
                               capacity_factor=capacity_factor)
    params = _ref_init(jax.random.PRNGKey(1), rconfigs.smoke_config(arch))
    model = tmodel.params_from_reference(jax.tree.map(np.asarray, params),
                                         tconfigs.smoke_config(arch),
                                         device="cpu")
    toks, _ = _inputs(rcfg, np.random.default_rng(17), 2, 21)
    want, raux = _ref_forward(params, jnp.asarray(toks), rcfg)
    got, aux = tmodels.forward(model, torch.tensor(toks), tcfg)
    _close(got, want, LOGIT_TOL)
    _close(aux, raux, LAYER_TOL)
    base, _ = tmodels.forward(model, torch.tensor(toks),
                              tconfigs.smoke_config(arch))
    assert not torch.equal(got, base)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b",
                                  "xlstm-1p3b"])
def test_full_configs_build(arch):
    """The published MoE/MLA configs and xLSTM's build (on the meta
    device: 236 B, 1 T and 3.48 B parameters), with the reference's
    parameter and active-parameter counts (its init traced
    abstractly)."""
    cfg = tconfigs.get(arch)
    model = tmodel.DecoderLM(cfg, generator=_gen(), device="meta")
    shapes = jax.eval_shape(lambda k: rmodel.init(k, rconfigs.get(arch)),
                            jax.random.PRNGKey(0))
    assert tmodels.param_count(model) == rmodel.param_count(shapes)
    assert tmodels.active_param_count(model, cfg) == \
        rmodel.active_param_count(shapes, rconfigs.get(arch))
