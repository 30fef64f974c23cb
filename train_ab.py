"""K9 f32's backward and the minitron-4b train step, for several trees of
this repo run in turns on one card.

Each tree is a checkout of the repo (its ``src/repro_torch`` is the port
it times).  For every tree in the order given, a process of its own
builds the tree's K9 f32 forward and backward kernels, then, as
``chip_smoke.py``'s phase 27 does:

* times ``kernels.attention.kernel.flash_backward`` at minitron-4b's
  attention layer (B 1, H 24, KV 8, S 4096, dh = dv = 128) and at the
  100M LM's (B 8, H 12, KV 6, S 256, dh = dv = 64), random float32
  inputs from a seeded generator, the mean of 5 launches by CUDA events
  after one warm-up, and beside each the library yardstick, autograd of
  ``scaled_dot_product_attention`` (causal, GQA) in float32, its backward
  alone;
* trains minitron-4b at full width in float32 cut to 8 layers (remat
  "full", its ``train_4k`` exec) on 1 x 4096 tokens of the port's
  SyntheticCorpus, random weights from a seed: one warm-up step, then 3
  steps timed by the host clock around synchronised calls (the median),
  tokens/s and the peak of ``torch.cuda.max_memory_allocated``.

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

#: (what, B, H, KV, S, dh): the backward's two timed layers.
LAYERS = (("minitron-4b layer", 1, 24, 8, 4096, 128),
          ("lm-768x12 layer", 8, 12, 6, 256, 64))


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
    """Times the backward and the train step with the port of ``tree``
    (already on sys.path)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import configs, models
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.kernels import common
    from repro_torch.kernels.attention import kernel as k9
    from repro_torch.train import (AdamWConfig, adamw_init, cosine_schedule,
                                   make_train_step)
    common.build([k9.LIB, k9.BWD_LIB])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for what, b, h, kv, s, d in LAYERS:
        gen = torch.Generator(device=dev).manual_seed(29)
        q = torch.randn((b, h, s, d), generator=gen, device=dev)
        k = torch.randn((b, kv, s, d), generator=gen, device=dev)
        v = torch.randn((b, kv, s, d), generator=gen, device=dev)
        do = torch.randn((b, h, s, d), generator=gen, device=dev)
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
    arch, layers, bsz, seq = "minitron-4b", 8, 1, 4096
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
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=27), seq, bsz)
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
    out["train"] = {"step_ms": ms, "steps_ms": times,
                    "tokens_per_s": bsz * seq / ms * 1e3, "peak_gib": peak}
    print(f"[train_ab] {tree} {arch} ({layers} layers, f32, {bsz} x "
          f"{seq}): {ms:.1f} ms a step (median of 3 after a warm-up; "
          + ", ".join(f"{t:.1f}" for t in times) + f"), "
          f"{bsz * seq / ms * 1e3:.0f} tokens/s, peak {peak:.1f} GiB",
          flush=True)
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
         **{w: round(r["times"][w]["bwd_ms"], 3) for w, *_ in LAYERS},
         "step_ms": round(r["times"]["train"]["step_ms"], 1)}
        for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
