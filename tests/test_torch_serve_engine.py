"""The port's serving engine (``repro_torch.serve.engine``) and serving
driver (``repro_torch.launch.serve``) against the reference's
``repro.serve.engine`` on the same weights (``params_from_reference``)
and numpy-seeded prompts, in float32 at the ``SMOKE`` sizes on the CPU.

Greedy tokens must be equal.  That is meaningful only where the
reference's top two logits at each generated position differ by more
than the port's logit tolerance (1e-4, ``tests/test_torch_models.py``):
the test takes the first prompt seed whose reference tokens clear that
gap on the reference's own teacher-forced logits (chosen on the
reference alone), so an argmax near a tie cannot pass or fail by
rounding.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as rmodel
from repro.serve import ServeEngine as RefEngine
from repro_torch import configs as tconfigs
from repro_torch.kernels.attention import kernel as k9
from repro_torch.kernels.gla import kernel as k10
from repro_torch.kernels.slstm import kernel as kslstm
from repro_torch.models import model as tmodel
from repro_torch.serve import (ServeEngine, make_decode_step,
                               make_prefill_step)

LOGIT_TOL = 1e-4
SLICE = ("granite-20b", "minitron-4b", "phi3-mini-3p8b", "starcoder2-15b",
         "musicgen-large", "qwen2-vl-2b", "zamba2-7b", "deepseek-v2-236b",
         "kimi-k2-1t-a32b", "xlstm-1p3b")
B, S, NEW = 2, 12, 6

_ref_init = jax.jit(rmodel.init, static_argnums=(1,))
_ref_forward = jax.jit(rmodel.forward, static_argnums=(2,))


def _weights(arch, seed=1):
    cfg = rconfigs.smoke_config(arch)
    params = _ref_init(jax.random.PRNGKey(seed), cfg)
    model = tmodel.params_from_reference(jax.tree.map(np.asarray, params),
                                         tconfigs.smoke_config(arch),
                                         device="cpu")
    return cfg, params, model


def _prompts(cfg, seed=0, b=B, s=S):
    shape = (b, s) if cfg.num_codebooks == 1 else (b, s, cfg.num_codebooks)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _top2_gap(params, cfg, prompts, out) -> float:
    """The least gap between the reference's top two logits (of any
    codebook) at the positions that chose ``out``'s tokens."""
    seq = np.concatenate([prompts, out], axis=1)
    logits, _ = _ref_forward(params, jnp.asarray(seq[:, :-1]), cfg)
    lg = np.asarray(logits)[:, prompts.shape[1] - 1:]
    lg = lg.reshape(lg.shape[:2] + (-1, cfg.vocab_size))
    top = np.sort(lg, axis=-1)[..., -2:]
    return float((top[..., 1] - top[..., 0]).min())


@pytest.mark.parametrize("arch", SLICE)
def test_greedy_tokens_equal_reference(arch):
    """``ServeEngine.generate`` (prefill, then NEW - 1 decode steps):
    the port's greedy tokens are the reference's, and no kernel launched
    on the CPU."""
    cfg, params, model = _weights(arch)
    ref = RefEngine(params, cfg, max_len=S + NEW)
    # the first prompt seed whose reference tokens are clear of a tie
    # (chosen on the reference alone)
    for seed in range(8):
        prompts = _prompts(cfg, seed)
        want = np.asarray(ref.generate(prompts, max_new=NEW))
        if _top2_gap(params, cfg, prompts, want) > LOGIT_TOL:
            break
    else:
        pytest.fail(f"{arch}: every prompt seed ties within {LOGIT_TOL}")
    launches = lambda: (k9.LIB.launches, k9.BF16_LIB.launches,
                        k10.LIB.launches, kslstm.LIB.launches)
    before = launches()
    got = ServeEngine(model, tconfigs.smoke_config(arch),
                      max_len=S + NEW).generate(prompts, max_new=NEW)
    assert launches() == before
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_greedy_consistent_with_forward():
    """Feeding prompt + generated tokens back through ``forward``
    reproduces each greedy token (the reference's test_serve check on
    the port alone)."""
    cfg = tconfigs.smoke_config("zamba2-7b")
    model = tmodel.init(cfg, device="cpu")
    prompts = _prompts(cfg, seed=3, s=20)
    out = ServeEngine(model, cfg, max_len=40).generate(prompts, max_new=8)
    seq = np.concatenate([prompts, out], axis=1)
    logits, _ = tmodel.forward(model, torch.tensor(seq), cfg)
    pred = logits[:, 19:-1].argmax(-1).numpy()
    np.testing.assert_array_equal(pred, out)


def test_eos_stops_like_reference():
    """Generation stops once every sequence has emitted ``eos_id`` (the
    first token is never tested, as in the reference)."""
    cfg, params, model = _weights("granite-20b")
    prompts = _prompts(cfg, b=1)
    full = RefEngine(params, cfg, max_len=S + NEW).generate(prompts,
                                                            max_new=NEW)
    eos = int(np.asarray(full)[0, 2])
    want = RefEngine(params, cfg, max_len=S + NEW,
                     eos_id=eos).generate(prompts, max_new=NEW)
    got = ServeEngine(model, tconfigs.smoke_config("granite-20b"),
                      max_len=S + NEW, eos_id=eos).generate(prompts,
                                                            max_new=NEW)
    assert got.shape[1] < NEW
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ["musicgen-large", "phi3-mini-3p8b",
                                  "xlstm-1p3b"])
def test_temperature_sampling(arch):
    """Sampling draws from the caller's generator, which advances every
    step: one seed gives one output, another seed another; tokens stay
    in range (per codebook for musicgen); no generator is greedy."""
    cfg = tconfigs.smoke_config(arch)
    model = tmodel.init(cfg, device="cpu")
    engine = ServeEngine(model, cfg, max_len=S + 16, temperature=1.0)
    prompts = _prompts(cfg)
    draws = []
    for seed in (5, 5, 6):
        gen = torch.Generator().manual_seed(seed)
        state = gen.get_state().clone()
        draws.append(engine.generate(prompts, max_new=16, generator=gen))
        assert not torch.equal(gen.get_state(), state)
    np.testing.assert_array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[0], draws[2])
    shape = (B, 16) if cfg.num_codebooks == 1 else (B, 16, 4)
    assert all(d.shape == shape for d in draws)
    assert all(((d >= 0) & (d < cfg.vocab_size)).all() for d in draws)
    greedy = ServeEngine(model, cfg, max_len=S + 16).generate(prompts,
                                                              max_new=16)
    np.testing.assert_array_equal(
        engine.generate(prompts, max_new=16), greedy)


def test_steps_and_max_len():
    """``make_prefill_step`` and ``make_decode_step`` are the model's
    prefill and decode; a prompt past ``max_len`` is refused."""
    cfg, params, model = _weights("qwen2-vl-2b")
    tcfg = tconfigs.smoke_config("qwen2-vl-2b")
    toks = torch.tensor(_prompts(cfg))
    ee = torch.tensor(np.random.default_rng(8).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    caches = [tmodel.make_cache(tcfg, B, S + 2, concrete=True,
                                device="cpu") for _ in range(2)]
    a, caches[0] = make_prefill_step(tcfg)(model, toks, caches[0],
                                           extra_embeds=ee)
    b, caches[1] = tmodel.prefill(model, toks, caches[1], tcfg,
                                  extra_embeds=ee)
    assert torch.equal(a, b)
    tok = a.argmax(-1)
    a, _ = make_decode_step(tcfg)(model, tok, caches[0], S)
    b, _ = tmodel.decode_step(model, tok, caches[1], S, tcfg)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="max_len"):
        ServeEngine(model, tcfg, max_len=S + 2).generate(
            _prompts(cfg), max_new=3)


def test_launch_serve_cli(monkeypatch, capsys):
    """The serving driver on the CPU: it serves the SMOKE config (the
    reference's ``--smoke`` cannot be turned off) and prints the
    generated shape."""
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "musicgen-large", "--batch", "2",
        "--prompt-len", "8", "--max-new", "4", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "musicgen-smoke" in out and "(2, 4, 4)" in out


def test_launch_serve_cli_moe(monkeypatch, capsys):
    """The serving driver serves an MLA + MoE arch (kimi-k2's SMOKE)."""
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "kimi-k2-1t-a32b", "--batch", "2",
        "--prompt-len", "8", "--max-new", "4", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "kimi-smoke" in out and "(2, 4)" in out


def test_launch_serve_cli_xlstm(monkeypatch, capsys):
    """The serving driver serves xLSTM (its SMOKE: 7 mLSTM + 1 sLSTM)."""
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "xlstm-1p3b", "--batch", "2",
        "--prompt-len", "8", "--max-new", "4", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "xlstm-smoke" in out and "(2, 4)" in out
