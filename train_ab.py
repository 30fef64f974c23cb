"""The float32 backward kernels and the float32 train steps, for several
trees of this repo run in turns on one card.

Each tree is a checkout of the repo (its ``src/repro_torch`` is the port
it times).  For every tree in the order given, a process of its own
builds the tree's K9 f32 and K10 kernels and their backward kernels,
then, as ``chip_smoke.py``'s phase 27 does:

* times ``kernels.attention.kernel.flash_backward`` at minitron-4b's
  attention layer (B 1, H 24, KV 8, S 4096, dh = dv = 128), at the 100M
  LM's (B 8, H 12, KV 6, S 256, dh = dv = 64) and at deepseek-v2's MLA
  layer (B 1, H = KV = 128, S 4096, dh 192, dv 128), random float32
  inputs from a seeded generator, the mean of 5 launches by CUDA events
  after one warm-up, and beside each the library yardstick, autograd of
  ``scaled_dot_product_attention`` (causal, GQA) in float32, its backward
  alone;
* times ``kernels.gla.kernel.gla_chunks_backward`` at zamba2-7b's Mamba2
  layer (B 1, 112 heads, S 4096, dk = dv = 64, chunk 256) the same way
  (no library call computes it);
* trains minitron-4b (8 layers), zamba2-7b (12 of 81: its layer pattern
  twice) and deepseek-v2 (its first, dense layer) at full width in
  float32 (remat "full", their ``train_4k`` execs) on 1 x 4096 tokens of
  the port's SyntheticCorpus, random weights from a seed: one warm-up
  step, then 3 steps timed by the host clock around synchronised calls
  (the median), tokens/s and the peak of
  ``torch.cuda.max_memory_allocated``.

So ``python3 train_ab.py A B B A`` compares two trees with each timed
early and late in the call:

    python3 train_ab.py .dev/parent . . .dev/parent

prints one line a tree and measurement, a JSON summary last, and writes
the runs to ``chiprun_out/train_ab.json``.  It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

#: (what, B, H, KV, S, dh, dv): K9 f32's backward's timed layers.
LAYERS = (("minitron-4b layer", 1, 24, 8, 4096, 128, 128),
          ("lm-768x12 layer", 8, 12, 6, 256, 64, 64),
          ("deepseek-v2 layer", 1, 128, 128, 4096, 192, 128))
#: (what, B, H, S, dk, dv, chunk): K10 f32's backward's timed layer.
GLA_LAYER = ("zamba2-7b layer", 1, 112, 4096, 64, 64, 256)
#: (arch, layers): the float32 train steps.
STEPS = (("minitron-4b", 8), ("zamba2-7b", 12), ("deepseek-v2-236b", 1))


def _ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _one(tree: str) -> dict:
    """Times the backward kernels and the train steps with the port of
    ``tree`` (already on sys.path)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import configs, models
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.kernels import common
    from repro_torch.kernels.attention import kernel as k9
    from repro_torch.kernels.gla import kernel as k10
    from repro_torch.train import (AdamWConfig, adamw_init, cosine_schedule,
                                   make_train_step)
    common.build([k9.LIB, k9.BWD_LIB, k9.BWD_MLA_LIB, k10.LIB,
                  k10.BWD_LIB])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for what, b, h, kv, s, dh, dv in LAYERS:
        gen = torch.Generator(device=dev).manual_seed(29)
        q = torch.randn((b, h, s, dh), generator=gen, device=dev)
        k = torch.randn((b, kv, s, dh), generator=gen, device=dev)
        v = torch.randn((b, kv, s, dv), generator=gen, device=dev)
        do = torch.randn((b, h, s, dv), generator=gen, device=dev)
        o, lse = k9._launch_forward(q, k, v, True, with_lse=True)
        ms = _ms(lambda: k9.flash_backward(q, k, v, o, do, lse, 64, 64,
                                           True), 5)
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = F.scaled_dot_product_attention(*xs, is_causal=True,
                                             enable_gqa=True)
        sdpa = _ms(lambda: torch.autograd.grad(ref, xs, do,
                                               retain_graph=True), 5)
        out[what] = {"bwd_ms": ms, "sdpa_bwd_ms": sdpa}
        print(f"[train_ab] {tree} {what}: K9 f32 backward {ms:.3f} ms, "
              f"SDPA's backward {sdpa:.3f} ms", flush=True)
        del q, k, v, do, o, lse, xs, ref
        torch.cuda.empty_cache()
    what, b, h, s, dk, dv, chunk = GLA_LAYER
    gen = torch.Generator(device=dev).manual_seed(29)
    q = torch.randn((b, h, s, dk), generator=gen, device=dev)
    k = 0.3 * torch.randn((b, h, s, dk), generator=gen, device=dev)
    v = torch.randn((b, h, s, dv), generator=gen, device=dev)
    la = -0.2 * torch.randn((b, h, s), generator=gen, device=dev).abs()
    do = torch.randn((b, h, s, dv), generator=gen, device=dev)
    g = k10.chunk_cumsum(la, chunk)
    _, state, states = k10._launch_forward(q, k, v, g, chunk, torch.float32)
    states[:, :, -1] = state
    ms = _ms(lambda: k10.gla_chunks_backward(q, k, v, g, states, do, None,
                                             chunk), 5)
    out[what] = {"bwd_ms": ms}
    print(f"[train_ab] {tree} {what}: K10 f32 backward {ms:.3f} ms",
          flush=True)
    del q, k, v, la, do, g, states
    torch.cuda.empty_cache()
    bsz, seq = 1, 4096
    for arch, layers in STEPS:
        ex = configs.exec_default(arch, "train_4k")
        cfg = dataclasses.replace(configs.get(arch), num_layers=layers,
                                  param_dtype="float32", dtype="float32",
                                  remat=ex.remat)
        torch.cuda.reset_peak_memory_stats()
        model = models.init(cfg, generator=torch.Generator(
            device=dev).manual_seed(27), device=dev)
        opt_cfg = AdamWConfig(lr=3e-4)
        opt = adamw_init(model, opt_cfg)
        step = make_train_step(cfg, ex, opt_cfg, lr_schedule=lambda c: (
            cosine_schedule(c, peak_lr=3e-4, warmup=20, total=100)))
        pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=27), seq,
                            bsz)
        times = []
        for i in range(4):
            batch = pipe.batch_at(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt, met = step(model, opt, batch)
            float(met["loss"])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms = float(np.median(times[1:]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[arch] = {"step_ms": ms, "steps_ms": times,
                     "tokens_per_s": bsz * seq / ms * 1e3, "peak_gib": peak}
        print(f"[train_ab] {tree} {arch} ({layers} layers, f32, {bsz} x "
              f"{seq}): {ms:.1f} ms a step (median of 3 after a warm-up; "
              + ", ".join(f"{t:.1f}" for t in times) + f"), "
              f"{bsz * seq / ms * 1e3:.0f} tokens/s, peak {peak:.1f} GiB",
              flush=True)
        del model, opt, step
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="repo checkouts, timed in "
                    "this order")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        (tree,) = args.trees
        print(json.dumps(_one(tree)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("train_ab: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[train_ab] {card}", flush=True)
    here = os.path.abspath(__file__)
    runs = []
    for tree in args.trees:
        env = dict(os.environ, PYTHONPATH=os.path.join(
            os.path.abspath(tree), "src"))
        p = subprocess.run([sys.executable, here, "--one", tree], env=env,
                           stdout=subprocess.PIPE, text=True, check=True)
        lines = p.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), flush=True)
        runs.append({"tree": tree, "times": json.loads(lines[-1])})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "train_ab.json"), "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(json.dumps({"card": card, "runs": [
        {"tree": r["tree"],
         **{w: round(r["times"][w]["bwd_ms"], 3)
            for w in [x[0] for x in LAYERS] + [GLA_LAYER[0]]},
         **{f"{a} step_ms": round(r["times"][a]["step_ms"], 1)
            for a, _ in STEPS}}
        for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
