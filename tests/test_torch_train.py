"""The port's training path (``repro_torch.train.step``,
``repro_torch.launch.train``) against the reference's on the CPU:
``tests/test_train.py``'s checks run against the port; one train step of
the port against the reference's from carried weights and optimizer
state in every microbatch, gradient-compression and remat setting; and
the train driver in-process, with resume and ``--tuner-db``
(``tests/test_torch_train_archs.py`` holds the ten archs' SMOKE steps).

Tolerances: on ``CFG`` (``tests/test_train.py``'s) the loss within 1e-5
relative and the parameters within rtol 1e-4 / atol 1e-5 (the reference
test's own microbatch tolerance: both sides take float32 products and
sums in other orders).
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataPipeline as RefPipeline
from repro.data import SyntheticCorpus as RefCorpus
from repro.models import ModelConfig as RefConfig
from repro.models import model as rmodel
from repro.sharding.rules import ExecConfig as RefExec
from repro.train import optim as ropt
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.core.database import ReferenceDB
from repro_torch.data import DataPipeline, SyntheticCorpus
from repro_torch.launch import train as tlaunch
from repro_torch.models import ModelConfig, model
from repro_torch.sharding.rules import ExecConfig
from repro_torch.train.optim import (AdamWConfig, adamw_init,
                                     adamw_state_from_reference,
                                     cosine_schedule)
from repro_torch.train.step import make_train_step

CFG = ModelConfig(name="tiny", num_layers=2, d_model=64, num_heads=4,
                  num_kv_heads=2, d_ff=128, vocab_size=256,
                  param_dtype="float32", dtype="float32")
LOSS_REL = 1e-5
RTOL, ATOL = 1e-4, 1e-5


def _init(cfg, seed):
    return model.init(cfg, generator=torch.Generator().manual_seed(seed),
                      device="cpu")


def _clone(m):
    c = _init(m.cfg, 0)
    c.load_state_dict(m.state_dict())
    return c


def _params(m):
    return {k: p.detach().clone() for k, p in m.named_parameters()}


# ---------------------------------------------------------------------------
# tests/test_train.py against the port
# ---------------------------------------------------------------------------

def test_loss_decreases():
    m = _init(CFG, 0)
    opt_cfg = AdamWConfig(lr=3e-3)
    opt = adamw_init(m, opt_cfg)
    step = make_train_step(CFG, ExecConfig(), opt_cfg)
    pipe = DataPipeline(SyntheticCorpus(CFG.vocab_size), 32, 4)
    losses = []
    for s in range(25):
        opt, met = step(m, opt, pipe.batch_at(s))
        losses.append(float(met["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_microbatch_grad_equivalence():
    """microbatch=2 gives (numerically close) same update as microbatch=1."""
    m0 = _init(CFG, 1)
    opt_cfg = AdamWConfig(lr=1e-3)
    batch = DataPipeline(SyntheticCorpus(CFG.vocab_size), 32, 4).batch_at(0)
    outs = []
    for mb in (1, 2):
        m = _clone(m0)
        step = make_train_step(CFG, ExecConfig(microbatch=mb), opt_cfg)
        _, met = step(m, adamw_init(m, opt_cfg), batch)
        outs.append((_params(m), float(met["loss"])))
    assert outs[0][1] == pytest.approx(outs[1][1], rel=1e-5)
    for k in outs[0][0]:
        np.testing.assert_allclose(outs[0][0][k].numpy(),
                                   outs[1][0][k].numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_grad_compression_close():
    m0 = _init(CFG, 2)
    opt_cfg = AdamWConfig(lr=1e-3)
    batch = DataPipeline(SyntheticCorpus(CFG.vocab_size), 32, 4).batch_at(0)
    ps = []
    for gc in ("none", "bf16"):
        m = _clone(m0)
        step = make_train_step(
            CFG, ExecConfig(microbatch=2, grad_compress=gc), opt_cfg)
        step(m, adamw_init(m, opt_cfg), batch)
        ps.append(_params(m))
    # bf16 compression is approximate but close
    assert max(float((ps[0][k] - ps[1][k]).abs().max())
               for k in ps[0]) < 1e-2


def test_cosine_schedule_shape():
    s = np.array([float(cosine_schedule(torch.tensor(i, dtype=torch.int32),
                                        peak_lr=1.0, warmup=10, total=100))
                  for i in (0, 5, 10, 55, 100)])
    assert s[0] == 0.0
    assert s[1] == pytest.approx(0.5)
    assert s[2] == pytest.approx(1.0)
    assert 0.1 < s[3] < 1.0
    assert s[4] == pytest.approx(0.1, rel=1e-3)


def test_remat_matches_no_remat():
    batch = DataPipeline(SyntheticCorpus(CFG.vocab_size), 32, 4).batch_at(0)
    m0 = _init(CFG, 3)
    opt_cfg = AdamWConfig(lr=1e-3)
    outs = []
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(CFG, remat=remat)
        m = _clone(m0)
        _, met = make_train_step(cfg, ExecConfig(), opt_cfg)(
            m, adamw_init(m, opt_cfg), batch)
        outs.append((float(met["loss"]), _params(m)))
    for loss, ps in outs[1:]:
        # remat changes when values are computed, never what they are
        assert loss == outs[0][0]
        assert all(torch.equal(ps[k], outs[0][1][k]) for k in ps)


# ---------------------------------------------------------------------------
# one step against the reference's
# ---------------------------------------------------------------------------

def _ref_cfg(cfg):
    return RefConfig(**dataclasses.asdict(cfg))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _assert_params_close(m, ref_params, cfg, rtol, atol):
    want = model.flat_from_reference(_np_tree(ref_params), cfg)
    got = dict(m.named_parameters())
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().float().numpy(), want[k],
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("grad_compress", ["none", "bf16"])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_step_vs_reference(microbatch, grad_compress, remat):
    """The reference takes a step from its init; its weights and
    optimizer state are carried to the port (``params_from_reference``,
    ``adamw_state_from_reference``); then both take the next step on the
    same batch: the same loss, lr, aux terms and parameters."""
    cfg = dataclasses.replace(CFG, remat=remat)
    rcfg = _ref_cfg(cfg)
    ex = dict(microbatch=microbatch, grad_compress=grad_compress)
    ropt_cfg = ropt.AdamWConfig(lr=1e-3)
    sched = dict(peak_lr=1e-3, warmup=1, total=10)
    rstep = jax.jit(ref_make_train_step(
        rcfg, RefExec(**ex), ropt_cfg,
        lr_schedule=lambda s: ropt.cosine_schedule(s, **sched)))
    pipe = RefPipeline(RefCorpus(cfg.vocab_size), 32, 4)
    params = rmodel.init(jax.random.PRNGKey(4), rcfg)
    params, state, _ = rstep(params, ropt.adamw_init(params, ropt_cfg),
                             {k: jnp.asarray(v)
                              for k, v in pipe.batch_at(0).items()})
    m = model.params_from_reference(_np_tree(params), cfg, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = adamw_state_from_reference(_np_tree(state), m, opt_cfg)
    batch = pipe.batch_at(1)
    p2, s2, want = rstep(params, state,
                         {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(cfg, ExecConfig(**ex), opt_cfg,
                           lr_schedule=lambda s: cosine_schedule(s, **sched))
    opt2, got = step(m, opt, batch)
    assert sorted(got) == sorted(want) == ["aux", "ce", "grad_norm", "loss",
                                           "lr"]
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]),
                                                rel=LOSS_REL, abs=1e-12), key
    assert int(opt2.count) == int(s2.count) == 2
    _assert_params_close(m, p2, cfg, RTOL, ATOL)


# ---------------------------------------------------------------------------
# the train driver
# ---------------------------------------------------------------------------

def _step_arrays(ckpt_dir, step):
    """The arrays of a checkpoint step and its manifest."""
    d = os.path.join(ckpt_dir, f"step_{step:06d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}, manifest


def test_driver_resume_and_tuner_db(tmp_path):
    """``--arch minitron-4b --smoke --steps 10 --device cpu`` on 4 x 64
    tokens (small: the suite runs beside five other workers): the loss
    falls, a resume from the step-5 checkpoint ends on the uninterrupted
    run's losses, parameters and optimizer state within 1e-6
    (``tests/test_checkpoint.py``'s resume tolerance; not bitwise: the
    embedding gather's backward on a multi-threaded CPU adds a token's
    rows in a varying order, so two uninterrupted runs differ in the
    last bits too), and the tuner DB holds the run's 512-sample
    signature and exec config."""
    a, b, db = (str(tmp_path / n) for n in ("a", "b", "db"))
    args = ["--arch", "minitron-4b", "--smoke", "--steps", "10",
            "--device", "cpu", "--seq", "64", "--batch", "4",
            "--ckpt-every", "5", "--log-every", "5"]
    run = tlaunch.main(args + ["--ckpt-dir", a, "--tuner-db", db])
    assert run["losses"][-1] < run["losses"][0]
    assert len(run["losses"]) == 10
    os.makedirs(b)
    shutil.copytree(os.path.join(a, "step_000005"),
                    os.path.join(b, "step_000005"))
    with open(os.path.join(b, "LATEST"), "w") as f:
        f.write("step_000005")
    resumed = tlaunch.main(args + ["--ckpt-dir", b, "--resume"])
    np.testing.assert_allclose(resumed["losses"], run["losses"][5:],
                               rtol=1e-6)
    (want, ws), (got, gs) = _step_arrays(a, 10), _step_arrays(b, 10)
    assert ws["step"] == gs["step"] == 10 and ws["treedef"] == gs["treedef"]
    assert sorted(want) == sorted(got) and len(want) > 0
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    rdb = ReferenceDB.load(db)
    assert rdb.workloads() == [run["workload"]] == \
        ["minitron-smoke/train_64x4"]
    assert rdb.best_config(run["workload"]) == ExecConfig().as_dict()
    (entry,) = rdb.series_for(run["workload"])
    assert entry.series.shape == (512,) and np.isfinite(entry.series).all()


def test_driver_default_config_and_device():
    """``build_config``'s default is the ~100M lm-768x12 (12 heads, KV 6,
    head dim 64) and an arch is forced to float32; ``--device`` is CUDA
    unless named, which raises without a card."""
    args = tlaunch.parse_args([])
    cfg = tlaunch.build_config(args)
    assert (cfg.name, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.dtype) == \
        ("lm-768x12", 12, 6, 64, 3072, 32768, "float32")
    assert args.device == "cuda" and (args.seq, args.batch) == (256, 8)
    arch = tlaunch.build_config(tlaunch.parse_args(
        ["--arch", "zamba2-7b", "--smoke"]))
    assert (arch.param_dtype, arch.dtype) == ("float32", "float32")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tlaunch.main(["--steps", "1", "--layers", "1", "--d-model",
                          "64", "--vocab", "64"])
