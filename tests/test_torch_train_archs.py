"""The train step of ``tests/test_arch_smoke.py``
(``test_smoke_forward_and_train_step``) for all ten archs' SMOKE configs,
the port (``repro_torch.train.step``, on the CPU) against the reference
from the reference's init weights.

Tolerances: the loss, its cross-entropy and the gradient norm within
1e-5 relative; the parameters after the step within rtol 1e-4 and atol
``SMOKE_ATOL``: 2e-4, and 1e-3 for xlstm-1p3b.  The first AdamW step
moves a weight by lr g / (|g| + eps), whose size does not shrink with
|g|: where a gradient element is float32 noise (the two frameworks'
gradients agree to ~2e-5 of each leaf's largest, summing in other
orders), the two steps may differ by up to 2 lr = 2e-3 there.  xlstm's
eight recurrent layers give the most such noise (3.9e-4 beyond rtol 1e-4
measured on the CPU; every other arch under 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as rmodel
from repro.sharding.rules import ExecConfig as RefExec
from repro.train import optim as ropt
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.models import model
from repro_torch.sharding.rules import ExecConfig
from repro_torch.train.optim import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step

LOSS_REL = 1e-5
RTOL = 1e-4
SMOKE_ATOL = {"xlstm-1p3b": 1e-3}
SMOKE_ATOL_DEFAULT = 2e-4


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _params(m):
    return {k: p.detach().clone() for k, p in m.named_parameters()}


def _assert_params_close(m, ref_params, cfg, rtol, atol):
    want = model.flat_from_reference(_np_tree(ref_params), cfg)
    got = dict(m.named_parameters())
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().float().numpy(), want[k],
                                   rtol=rtol, atol=atol, err_msg=k)


def _smoke_batch(cfg, B=2, S=32, seed=0):
    """``tests/test_arch_smoke.py``'s batch, as numpy arrays."""
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


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_smoke_train_step_vs_reference(arch):
    """``test_smoke_forward_and_train_step``'s step (AdamW lr 1e-3 from
    an all-zero state) from the reference's init weights, port against
    reference: loss and gradient norm, and every parameter, which moved."""
    rcfg = rconfigs.smoke_config(arch)
    params = rmodel.init(jax.random.PRNGKey(0), rcfg)
    batch = _smoke_batch(rcfg)
    rstep = jax.jit(ref_make_train_step(rcfg, RefExec(),
                                        ropt.AdamWConfig(lr=1e-3)))
    p2, _, want = rstep(params, ropt.adamw_init(params, ropt.AdamWConfig()),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = tconfigs.smoke_config(arch)
    m = model.params_from_reference(_np_tree(params), cfg, device="cpu")
    before = _params(m)
    step = make_train_step(cfg, ExecConfig(), AdamWConfig(lr=1e-3))
    _, got = step(m, adamw_init(m, AdamWConfig()), batch)
    assert np.isfinite(float(got["loss"]))
    for key in ("loss", "grad_norm", "ce"):
        assert float(got[key]) == pytest.approx(float(want[key]),
                                                rel=LOSS_REL), key
    _assert_params_close(m, p2, cfg, RTOL,
                         SMOKE_ATOL.get(arch, SMOKE_ATOL_DEFAULT))
    first = next(iter(before))
    assert not torch.allclose(before[first], m.get_parameter(first))
