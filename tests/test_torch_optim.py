"""The port's AdamW (``repro_torch.train.optim``) against the reference's
(``repro.train.optim``) on the same numpy-seeded trees of several
leaves: ``global_norm``, ``clip_by_global_norm``, ``adamw_update`` over
several steps (with and without clipping, float32 and bfloat16 moments,
float32 and bfloat16 parameters), ``cosine_schedule``, and a reference
state carried across by ``adamw_state_from_reference``.

Tolerances: parameters and float32 moments within rtol 1e-6 / atol 1e-7
(both take the same float32 operations in the same order; PyTorch's and
XLA's float32 ``pow`` in the bias corrections may differ in the last
bit); a bfloat16 moment within one bfloat16 step of the reference's (a
float32 difference in the last bit may round the other way); norms and
schedule values within rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as ropt
from repro_torch.train import optim as topt

RTOL, ATOL = 1e-6, 1e-7
BF16_STEP = 2.0 ** -7

SHAPES = {"embed": (17, 8), "layers": (3, 8, 8), "norm": (8,),
          "bias": (1,), "w_out": (8, 5)}


def _tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in shapes.items()}


def _ref(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _port(tree, dtype=torch.float32):
    return {k: torch.tensor(v).to(dtype) for k, v in tree.items()}


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_global_norm_and_clip(scale):
    tree = _tree(1, scale)
    gn_r = float(ropt.global_norm(_ref(tree)))
    gn_t = float(topt.global_norm(_port(tree)))
    assert gn_t == pytest.approx(gn_r, rel=RTOL)
    clipped_r, n_r = ropt.clip_by_global_norm(_ref(tree), 1.0)
    clipped_t, n_t = topt.clip_by_global_norm(_port(tree), 1.0)
    assert float(n_t) == pytest.approx(float(n_r), rel=RTOL)
    _close(clipped_t, clipped_r)
    if gn_r > 1.0:
        assert float(topt.global_norm(clipped_t)) == pytest.approx(
            1.0, rel=1e-5)


def test_global_norm_takes_a_module():
    model = torch.nn.Linear(4, 3)
    tree = {k: p.detach() for k, p in model.named_parameters()}
    with torch.no_grad():
        assert float(topt.global_norm(model)) == float(
            topt.global_norm(tree))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-2, 10.0])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_vs_reference(moment_dtype, grad_scale, param_dtype):
    """Five steps of both optimizers from the same parameters and
    gradients (clipping active at grad_scale 10), with a scheduled lr on
    alternate steps: the same parameters and moments."""
    cfg_r = ropt.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    cfg_t = topt.AdamWConfig(**dataclasses.asdict(cfg_r))
    pdt_r = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    pdt_t = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[param_dtype]
    p_r, p_t = _ref(_tree(0), pdt_r), _port(_tree(0), pdt_t)
    s_r, s_t = ropt.adamw_init(p_r, cfg_r), topt.adamw_init(p_t, cfg_t)
    for step in range(5):
        g = _tree(100 + step, grad_scale)
        lr = None
        if step % 2:
            lr_r = ropt.cosine_schedule(s_r.count, peak_lr=1e-2, warmup=2,
                                        total=8)
            lr_t = topt.cosine_schedule(s_t.count, peak_lr=1e-2, warmup=2,
                                        total=8)
            assert float(lr_t) == pytest.approx(float(lr_r), rel=RTOL)
            lr = (lr_r, lr_t)
        p_r, s_r, m_r = ropt.adamw_update(_ref(g, pdt_r), s_r, p_r, cfg_r,
                                          lr=None if lr is None else lr[0])
        p_t, s_t, m_t = topt.adamw_update(_port(g, pdt_t), s_t, p_t, cfg_t,
                                          lr=None if lr is None else lr[1])
        assert int(s_t.count) == int(s_r.count) == step + 1
        assert float(m_t["grad_norm"]) == pytest.approx(
            float(m_r["grad_norm"]), rel=RTOL)
        if param_dtype == "float32":
            _close(p_t, p_r)
        else:                      # a bfloat16 parameter: one bf16 step
            _close(p_t, p_r, rtol=BF16_STEP, atol=ATOL)
        if moment_dtype == "float32":
            _close(s_t.m, s_r.m)
            _close(s_t.v, s_r.v)
        else:
            assert all(x.dtype == torch.bfloat16 for x in s_t.m.values())
            _close(s_t.m, s_r.m, rtol=BF16_STEP, atol=ATOL)
            _close(s_t.v, s_r.v, rtol=BF16_STEP, atol=ATOL)
        # carry the reference's own state on, so bf16 roundings that
        # differ in one element do not compound over the steps
        s_t = topt.AdamWState(
            count=s_t.count, m=_port({k: _np(v) for k, v in s_r.m.items()},
                                     s_t.m["norm"].dtype),
            v=_port({k: _np(v) for k, v in s_r.v.items()},
                    s_t.v["norm"].dtype))
        p_t = _port({k: _np(v) for k, v in p_r.items()}, pdt_t)


def test_adamw_update_in_place():
    """The parameter tensors and moments take their new values in place
    (a model's parameters): the returned trees hold the same tensors."""
    cfg = topt.AdamWConfig(lr=1e-2)
    p = _port(_tree(0))
    st = topt.adamw_init(p, cfg)
    ids = {k: id(v) for k, v in p.items()}
    before = {k: v.clone() for k, v in p.items()}
    got, st2, _ = topt.adamw_update(_port(_tree(1)), st, p, cfg)
    for k in p:
        assert id(got[k]) == ids[k] and st2.m[k] is st.m[k]
        assert not torch.equal(p[k], before[k])
    assert int(st2.count) == 1 and int(st.count) == 0


@pytest.mark.parametrize("warmup,total", [(10, 100), (20, 60), (0, 5)])
def test_cosine_schedule_vs_reference(warmup, total):
    for s in list(range(0, total + 3, max(total // 17, 1))) + [warmup]:
        want = float(ropt.cosine_schedule(jnp.int32(s), peak_lr=3e-4,
                                          warmup=warmup, total=total))
        got = topt.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                   peak_lr=3e-4, warmup=warmup, total=total)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=RTOL, abs=1e-12)


def test_cosine_schedule_shape():
    s = np.array([float(topt.cosine_schedule(torch.tensor(i), peak_lr=1.0,
                                             warmup=10, total=100))
                  for i in (0, 5, 10, 55, 100)])
    assert s[0] == 0.0
    assert s[1] == pytest.approx(0.5)
    assert s[2] == pytest.approx(1.0)
    assert 0.1 < s[3] < 1.0
    assert s[4] == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_state_from_reference(moment_dtype):
    """A reference AdamWState over a model's parameter tree, carried
    across onto the port's model by name: the moments equal, and the
    next update from it equals the reference's next update."""
    from repro.models import ModelConfig, model as rmodel
    from repro_torch.models import model as tmodel
    from repro_torch.models.config import ModelConfig as TConfig
    cfg = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=64,
                      param_dtype="float32", dtype="float32")
    tcfg = TConfig(**dataclasses.asdict(cfg))
    params = rmodel.init(jax.random.PRNGKey(0), cfg)
    cfg_r = ropt.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    cfg_t = topt.AdamWConfig(**dataclasses.asdict(cfg_r))
    grads = jax.tree.map(lambda p: jnp.asarray(np.random.default_rng(
        p.size).normal(size=p.shape).astype(np.float32)), params)
    _, state, _ = ropt.adamw_update(grads, ropt.adamw_init(params, cfg_r),
                                    params, cfg_r)
    model = tmodel.params_from_reference(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    st = topt.adamw_state_from_reference(jax.tree.map(np.asarray, state),
                                         model, cfg_t)
    assert int(st.count) == 1 and sorted(st.m) == sorted(
        dict(model.named_parameters()))
    flat_m = tmodel.flat_from_reference(jax.tree.map(
        lambda x: np.asarray(x, np.float32), state.m), tcfg)
    for k, m in st.m.items():
        assert m.dtype == topt._DTYPES[moment_dtype]
        np.testing.assert_array_equal(m.float().numpy(), flat_m[k])
    p2, s2, _ = ropt.adamw_update(grads, state, params, cfg_r)
    g_t = {k: torch.tensor(v) for k, v in tmodel.flat_from_reference(
        jax.tree.map(np.asarray, grads), tcfg).items()}
    got, st2, _ = topt.adamw_update(g_t, st, model, cfg_t)
    want = tmodel.flat_from_reference(jax.tree.map(np.asarray, p2), tcfg)
    _close(got, {k: torch.tensor(v) for k, v in want.items()})
    assert int(st2.count) == int(s2.count) == 2
