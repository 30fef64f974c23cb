"""Single-card training driver — the port of ``repro/launch/train.py``,
with ``--device`` (CUDA unless another is named; CUDA without a card
raises).

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
        --smoke --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --d-model 768 \\
        --layers 12 --steps 300 --seq 256 --batch 8   # ~100M-param run

Features: the deterministic data pipeline, AdamW with the cosine
schedule (warmup 20), gradient accumulation, checkpoint and exact
restart (``--ckpt-dir``, ``--resume``), heartbeat and straggler
bookkeeping, and the paper's AutoTuner hook: ``--tuner-db`` records the
run's utilization signature (``core.signatures.signature_of`` over
``loss_fn`` on ``meta`` tensors) and its exec config in the reference DB,
so later runs can inherit tuned settings by DTW matching.

Every config is trained in float32, as the reference's driver forces.
On the card the attention runs K9 f32 and its backward kernels (at
MLA's 192-wide head too) and Mamba2's scan K10 f32 and its backward
kernel, so every arch but xlstm trains there (minitron-4b, granite-20b,
phi3-mini, starcoder2-15b, qwen2-vl, musicgen-large, deepseek-v2,
kimi-k2, zamba2 and the default LM); xlstm raises
``NotImplementedError`` naming the sLSTM scan's missing backward kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from .. import configs as cfglib
from ..checkpoint import CheckpointManager
from ..core.database import ReferenceDB
from ..core.signatures import signature_of
from ..core.tuner import AutoTuner
from ..data import DataPipeline, SyntheticCorpus
from ..kernels.common import resolve_device
from ..models import model as model_lib
from ..models.config import ModelConfig
from ..runtime import HeartbeatTracker, StragglerDetector
from ..sharding.rules import ExecConfig
from ..train.optim import AdamWConfig, AdamWState, adamw_init, \
    cosine_schedule
from ..train.step import make_train_step


def build_config(args) -> ModelConfig:
    if args.arch:
        cfg = (cfglib.smoke_config(args.arch) if args.smoke
               else cfglib.get(args.arch))
        return dataclasses.replace(cfg, param_dtype="float32", dtype="float32")
    return ModelConfig(
        name=f"lm-{args.d_model}x{args.layers}",
        num_layers=args.layers, d_model=args.d_model,
        num_heads=max(args.d_model // 64, 1),
        num_kv_heads=max(args.d_model // 128, 1),
        d_ff=args.d_model * 4, vocab_size=args.vocab,
        param_dtype="float32", dtype="float32")


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tuner-db", default=None,
                    help="reference DB dir: record this run's signature")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _state_tree(model: torch.nn.Module, opt: AdamWState):
    """(params, (count, m, v)): the checkpoint's tree, as the reference
    saves (params, opt_state)."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    return params, (opt.count, opt.m, opt.v)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train; returns {"losses", "model", "opt_state", "workload"}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = build_config(args)
    print(f"[train] config {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} on {dev}")

    model = model_lib.init(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    print(f"[train] {model_lib.param_count(model)/1e6:.1f}M params")

    opt_cfg = AdamWConfig(lr=args.lr)
    opt_state = adamw_init(model, opt_cfg)
    ex = ExecConfig(microbatch=args.microbatch)
    sched = lambda s: cosine_schedule(s, peak_lr=args.lr, warmup=20,
                                      total=args.steps)
    step_fn = make_train_step(cfg, ex, opt_cfg, lr_schedule=sched)

    corpus = SyntheticCorpus(cfg.vocab_size,
                             num_codebooks=max(cfg.num_codebooks, 1))
    pipe = DataPipeline(corpus, seq_len=args.seq, global_batch=args.batch)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        (params, (count, m, v)), manifest = mgr.restore(
            _state_tree(model, opt_state), device=dev)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(params[k])
        opt_state = AdamWState(count=count, m=m, v=v)
        start_step = manifest["metadata"]["next_step"]
        print(f"[train] resumed from step {start_step}")

    hb = HeartbeatTracker(timeout=600.0)
    sd = StragglerDetector()

    losses: List[float] = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        t0 = time.time()
        opt_state, metrics = step_fn(model, opt_state, pipe.batch_at(step))
        loss = float(metrics["loss"])        # waits for the step
        dt = time.time() - t0
        hb.beat(0, step, time.time())
        sd.record(0, dt)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq / dt
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms "
                  f"({tok_s:.0f} tok/s)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, _state_tree(model, opt_state),
                     {"next_step": step + 1, "loss": loss})

    if mgr:
        mgr.save(args.steps, _state_tree(model, opt_state),
                 {"next_step": args.steps, "loss": losses[-1]})

    print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"in {time.time()-t_start:.0f}s")
    assert losses[-1] < losses[0], "loss did not improve"

    workload = f"{cfg.name}/train_{args.seq}x{args.batch}"
    if args.tuner_db:
        db = (ReferenceDB.load(args.tuner_db)
              if os.path.exists(os.path.join(args.tuner_db, "index.json"))
              else ReferenceDB())
        tuner = AutoTuner(db, device=dev)
        meta = model_lib.DecoderLM(
            cfg, generator=torch.Generator().manual_seed(0), device="meta")
        batch = {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
                 for k, v in pipe.batch_at(0).items()}
        sig = signature_of(
            lambda m, b: model_lib.loss_fn(m, b, cfg)[0], meta, batch)
        tuner.record(workload, ex.as_dict(),
                     score=float(-losses[-1]), series=sig)
        db.save(args.tuner_db)
        print(f"[train] recorded signature + exec config for {workload} "
              f"in {args.tuner_db}")
    return {"losses": losses, "model": model, "opt_state": opt_state,
            "workload": workload}


if __name__ == "__main__":
    main()
