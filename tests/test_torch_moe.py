"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against
the reference's ``repro.models.moe`` on the same weights (the reference's
``moe_init`` tree loaded into the port's ``MoE``) and numpy-seeded
inputs, in float32 on the CPU.

Tolerances: outputs within OUT_TOL = 1e-5 absolute (both sides take the
same products and add a token's contributions in the same order, rising
expert id; the GEMMs sum in another order); the aux loss within
AUX_TOL = 1e-6.  The routing (each token's chosen experts in order, and
each assignment's slot in the [E, C] dispatch) is compared bitwise.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as RConfig
from repro.models import moe as rmoe
from repro_torch.models import ModelConfig
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.sharding import make_mesh

OUT_TOL = 1e-5
AUX_TOL = 1e-6

#: tests/test_moe.py's config.
KW = dict(name="moe-t", num_layers=1, d_model=32, num_heads=2,
          num_kv_heads=2, d_ff=64, vocab_size=64, num_experts=8, top_k=2,
          d_ff_expert=16, param_dtype="float32", dtype="float32")
CFG = ModelConfig(**KW)
RCFG = RConfig(**KW)


def _cfgs(**over):
    return dataclasses.replace(CFG, **over), dataclasses.replace(RCFG, **over)


def _port(p, cfg) -> tmoe.MoE:
    """The port's MoE holding the reference's tree ``p``."""
    mod = tmoe.MoE(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    flat = {}
    tmodel._flatten(p, "", flat)
    mod.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in flat.items()}, strict=True)
    return mod


def _both(p, x, cfg, rcfg):
    """(port out, port aux, reference out, reference aux) as numpy."""
    out, aux = tmoe.moe_apply(_port(p, cfg), torch.tensor(x), cfg)
    rout, raux = rmoe.moe_apply(p, jnp.asarray(x), rcfg)
    return out.numpy(), float(aux), np.asarray(rout), float(raux)


def _ref_routing(p, x2d, rcfg):
    """The reference's routing and dispatch, its own lines
    (``repro/models/moe.py:80-105``) on the whole expert range: (top_e
    [T, K], slot [T*K], keep [T*K])."""
    T = x2d.shape[0]
    E, K = rcfg.num_experts, rcfg.top_k
    C = rmoe._capacity(T, rcfg)
    logits = jnp.einsum("td,de->te", x2d, p["router"]["w"])
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, K)
    le = top_e.reshape(-1)
    onehot = jax.nn.one_hot(le, E + 1, dtype=jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
    keep = (le < E) & (pos < C)
    slot = jnp.where(keep, le * C + pos, E * C)
    return np.asarray(top_e), np.asarray(slot), np.asarray(keep)


def _port_routing(p, x2d, cfg):
    x = torch.tensor(x2d)
    _, _, top_e = tmoe.route(x, torch.tensor(np.asarray(p["router"]["w"])),
                             cfg)
    slot, keep = tmoe.dispatch(top_e, 0, cfg.num_experts,
                               tmoe._capacity(x.shape[0], cfg))
    return top_e.numpy(), slot.numpy(), keep.numpy()


def _normal(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))


def test_moe_output_shape_and_finite():
    """tests/test_moe.py's first case, the port held to the reference."""
    p = rmoe.moe_init(jax.random.PRNGKey(0), RCFG)
    x = _normal(1, (2, 16, 32))
    out, aux, rout, raux = _both(p, x, CFG, RCFG)
    assert out.shape == x.shape and np.isfinite(out).all() and aux > 0
    np.testing.assert_allclose(out, rout, rtol=0, atol=OUT_TOL)
    assert abs(aux - raux) <= AUX_TOL


@pytest.mark.parametrize("tokens", [1, 16, 100, 1024, 16384])
def test_capacity_formula(tokens):
    assert tmoe._capacity(tokens, CFG) == rmoe._capacity(tokens, RCFG) == \
        max(4, int(math.ceil(tokens * 2 * 1.25 / 8)))


def test_moe_capacity_drops_tokens_when_tight():
    """capacity_factor 0.05: the same assignments dropped, the same
    token rows zeroed, and more of them than at the full capacity."""
    cfg, rcfg = _cfgs(capacity_factor=0.05)
    p = rmoe.moe_init(jax.random.PRNGKey(0), rcfg)
    x = _normal(1, (1, 64, 32))
    out, _, rout, _ = _both(p, x, cfg, rcfg)
    np.testing.assert_allclose(out, rout, rtol=0, atol=OUT_TOL)
    got, want = _port_routing(p, x[0], cfg), _ref_routing(p, x[0], rcfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (~got[2]).sum() > 0
    full, _, _, _ = _both(p, x, CFG, RCFG)
    tight0 = np.linalg.norm(out[0], axis=-1) < 1e-6
    np.testing.assert_array_equal(
        tight0, np.linalg.norm(rout[0], axis=-1) < 1e-6)
    assert tight0.sum() > (np.linalg.norm(full[0], axis=-1) < 1e-6).sum()


def test_moe_shared_expert_always_active():
    cfg, rcfg = _cfgs(num_shared_experts=1, capacity_factor=0.01)
    p = rmoe.moe_init(jax.random.PRNGKey(0), rcfg)
    x = _normal(1, (1, 32, 32))
    out, _, rout, _ = _both(p, x, cfg, rcfg)
    assert np.linalg.norm(out) > 1e-3
    np.testing.assert_allclose(out, rout, rtol=0, atol=OUT_TOL)


def test_zero_router_ties_like_top_k():
    """A zero router ties every expert: the port's stable top-k picks
    jax.lax.top_k's experts (the lowest indices) with the same slots and
    aux (~1, balanced), where torch.topk picks others."""
    p = rmoe.moe_init(jax.random.PRNGKey(0), RCFG)
    p["router"]["w"] = jnp.zeros_like(p["router"]["w"])
    x = _normal(2, (4, 64, 32))
    x2d = x.reshape(-1, 32)
    got, want = _port_routing(p, x2d, CFG), _ref_routing(p, x2d, RCFG)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] == [0, 1]).all()
    probs = torch.softmax(torch.zeros(1, 8), dim=-1)
    assert torch.topk(probs, 2).indices.tolist() != [[0, 1]]
    out, aux, rout, raux = _both(p, x, CFG, RCFG)
    np.testing.assert_allclose(out, rout, rtol=0, atol=OUT_TOL)
    assert abs(aux - raux) <= AUX_TOL and 0.8 < aux < 1.3


def _dyadic(rng, shape, scale):
    return (rng.integers(-8, 9, size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dyadic_routing_bitwise(seed):
    """Inputs and weights on a dyadic grid (router logits exact in
    float32, many of them tied): the routing bitwise, the outputs within
    OUT_TOL, at a capacity that drops assignments."""
    cfg, rcfg = _cfgs(capacity_factor=0.5, num_shared_experts=1)
    rng = np.random.default_rng(seed)
    p = rmoe.moe_init(jax.random.PRNGKey(seed), rcfg)
    p = jax.tree.map(lambda w: jnp.asarray(_dyadic(rng, w.shape, 2.0 ** -5)),
                     p)
    p["router"]["w"] = jnp.asarray(_dyadic(rng, (32, 8), 2.0 ** -3) / 4)
    x = _dyadic(rng, (2, 24, 32), 2.0 ** -3)
    x2d = x.reshape(-1, 32)
    got, want = _port_routing(p, x2d, cfg), _ref_routing(p, x2d, rcfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (~got[2]).sum() > 0
    out, aux, rout, raux = _both(p, x, cfg, rcfg)
    np.testing.assert_allclose(out, rout, rtol=0, atol=OUT_TOL)
    assert abs(aux - raux) <= AUX_TOL


def test_expert_halves_sum_to_the_whole():
    """``_moe_local`` on the expert halves (``e_offset`` 0 and E / 2, the
    reference's expert shards) sums to the whole (the reference's psum),
    and each half is the reference's own half."""
    p = rmoe.moe_init(jax.random.PRNGKey(3), RCFG)
    x2d = _normal(4, (40, 32))
    ex = {k: np.asarray(v) for k, v in p["experts"].items()}
    rw = np.asarray(p["router"]["w"])
    whole, aux = tmoe._moe_local(torch.tensor(x2d), torch.tensor(rw),
                                 *(torch.tensor(ex[k]) for k in
                                   ("w_gate", "w_up", "w_down")), CFG)
    halves = []
    for lo in (0, 4):
        w = [ex[k][lo:lo + 4] for k in ("w_gate", "w_up", "w_down")]
        out, a = tmoe._moe_local(torch.tensor(x2d), torch.tensor(rw),
                                 *map(torch.tensor, w), CFG, e_offset=lo)
        rout, ra = rmoe._moe_local(jnp.asarray(x2d), jnp.asarray(rw),
                                   *map(jnp.asarray, w), RCFG,
                                   jnp.int32(lo), None)
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=0,
                                   atol=OUT_TOL)
        assert float(a) == float(aux) and abs(float(a) - float(ra)) <= \
            AUX_TOL
        halves.append(out)
    np.testing.assert_allclose((halves[0] + halves[1]).numpy(),
                               whole.numpy(), rtol=0, atol=OUT_TOL)


def test_moe_apply_mesh():
    """A mesh whose ``model`` axis shards the experts raises (expert
    parallelism is a later slice); a ``model`` axis of 1, or one that
    does not divide the experts, runs unmapped as the reference does."""
    p = rmoe.moe_init(jax.random.PRNGKey(0), RCFG)
    mod = _port(p, CFG)
    x = torch.tensor(_normal(1, (2, 8, 32)))
    want, _ = tmoe.moe_apply(mod, x, CFG)
    for shape, ok in (((2, 1), True), ((1, 3), True), ((1, 2), False)):
        mesh = make_mesh(shape, ("data", "model"),
                         devices=["cpu"] * math.prod(shape))
        if ok:
            got, _ = tmoe.moe_apply(mod, x, CFG, mesh=mesh)
            assert torch.equal(got, want)
        else:
            with pytest.raises(NotImplementedError, match="expert"):
                tmoe.moe_apply(mod, x, CFG, mesh=mesh)


def test_combine_is_in_rising_expert_order():
    """bf16 activations, where the order of a token's adds shows in the
    rounding: the port's combine equals a loop that adds each token's
    weighted expert outputs (the [E, C] buffer's rows at its slots) one at
    a time in rising expert id, in bf16, dropped assignments skipped."""
    cfg, _ = _cfgs(param_dtype="bfloat16", dtype="bfloat16", top_k=4,
                   capacity_factor=0.5)
    mod = tmoe.MoE(cfg, generator=torch.Generator().manual_seed(5),
                   device="cpu")
    T, K, E = 48, 4, 8
    x2d = torch.randn((T, 32), generator=torch.Generator().manual_seed(6)
                      ).bfloat16()
    ex = mod.experts
    out, _ = tmoe._moe_local(x2d, mod.router.w, ex.w_gate, ex.w_up,
                             ex.w_down, cfg)
    _, top_p, top_e = tmoe.route(x2d, mod.router.w, cfg)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    C = tmoe._capacity(T, cfg)
    slot, keep = tmoe.dispatch(top_e, 0, E, C)
    xe = torch.zeros((E * C, 32), dtype=torch.bfloat16)
    xe[slot[keep]] = x2d.repeat_interleave(K, 0)[keep]
    xe = xe.reshape(E, C, 32)
    h = torch.nn.functional.silu(torch.bmm(xe, ex.w_gate)) \
        * torch.bmm(xe, ex.w_up)
    ye = torch.bmm(h, ex.w_down).reshape(E * C, 32)
    want = torch.zeros_like(x2d)
    for t in range(T):
        for k in sorted(range(K), key=lambda k: int(top_e[t, k])):
            i = t * K + k
            if keep[i]:
                want[t] = want[t] + ye[slot[i]] * top_p[t, k].bfloat16()
    assert (~keep).sum() > 0
    assert torch.equal(out, want)
