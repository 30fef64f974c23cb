"""K9's bfloat16 backward and the bf16 train steps, for several trees of
this repo run in turns on one card.

Each tree is a checkout of the repo (its ``src/repro_torch`` is the port
it times).  For every tree in the order given, a process of its own builds
the tree's K9 bf16 kernels, then:

* prints each backward kernel's registers and spills as ``ptxas -v``
  reported them, and any ptxas warning (a serialized ``wgmma`` pipeline),
  parsed by ``chip_smoke.py``'s ``ptxas_logs`` and ``ptxas_kernels``;
* at the six timed shapes of ``chip_smoke.py``'s phase 29 (a) (the
  training layers of minitron-4b, deepseek-v2's MLA, phi3-mini,
  zamba2-7b's shared attention, the 100M LM and kimi-k2's MLA), bf16
  inputs from a seeded generator and the bf16 forward's own o and lse,
  times ``kernels.attention.kernel.flash_backward`` (the mean of 5
  launches by CUDA events after one warm-up), each of its kernels' device
  time (``torch.profiler``, 3 launches), and the library yardstick,
  autograd of ``scaled_dot_product_attention`` (causal, GQA) in bf16, its
  backward alone; the first tree's gradients are kept, and every later
  tree's are compared with them (bitwise, else the largest difference);
* times the host's side of a call apart from the card's: with the card
  held busy by a queued ``torch.cuda._sleep``, the host clock over 20
  calls of ``flash_backward`` (allocations, checks and the C entry point)
  and of the C entry point alone on preallocated outputs, once with
  ``vec`` 1 (the tree's TMA tensor maps built, where it builds any) and
  once with ``vec`` 0 (none built, the kernels' thread loads), so that the
  difference is what the maps cost the host;
* trains minitron-4b (8 layers) and deepseek-v2 (its dense layer) in
  bf16 at full width (remat "full", their ``train_4k`` execs) on 1 x 4096
  tokens of the port's SyntheticCorpus, random weights from a seed, as
  phase 29 (b) does: one warm-up step, then 3 steps timed by the host
  clock around synchronised calls (the median).

So ``python3 bf16_bwd_ab.py A B B A`` compares two trees with each timed
early and late in the call:

    python3 bf16_bwd_ab.py .dev/parent . . .dev/parent

prints one line a tree and measurement, a JSON summary last, and writes
the runs to ``chiprun_out/bf16_bwd_ab.json``.  It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

#: (what, B, H, KV, S, dh, dv): the six timed shapes of phase 29 (a).
SHAPES = (("minitron-4b layer", 1, 24, 8, 4096, 128, 128),
          ("deepseek-v2 MLA layer", 1, 128, 128, 4096, 192, 128),
          ("phi3-mini layer (dh 96)", 1, 32, 32, 4096, 96, 96),
          ("zamba2-7b shared attention (dh 112)", 1, 32, 32, 4096, 112, 112),
          ("lm-768x12 layer (dh 64)", 8, 12, 6, 256, 64, 64),
          ("kimi-k2 MLA layer (64 heads)", 1, 64, 64, 4096, 192, 128))
#: (arch, layers): phase 29 (b)'s bf16 train steps.
STEPS = (("minitron-4b", 8), ("deepseek-v2-236b", 1))


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


def _kernel_ms(fn) -> dict:
    """Each CUDA kernel's device time a call of ``fn`` (3 calls traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0)
        if t:
            name = re.sub(r"^(void )?(bf16_bwd::)?", "", ev.key).split("(")[0]
            out[name] = t / 3 / 1e3
    return out


def _host_ms(fn, calls: int = 20) -> float:
    """The host's time a call of ``fn`` while the card is held busy, so
    that no call waits on it: the launches only queue."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of the card's clock
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return ms


def _entry(k9, q, k, v, o, do, lse, vec: int):
    """The bf16 backward's C entry point on preallocated outputs, as
    ``flash_backward`` calls it but with ``vec`` given: a function of no
    arguments that makes one call."""
    import numpy as np
    import torch
    b, h, s, dh = q.shape
    kv, t, dv = k.shape[1], k.shape[2], v.shape[-1]
    fn = "flash_attention_bwd_bf16_mla" if dh > k9.MAX_BWD_D \
        else "flash_attention_bwd_bf16"
    lib = k9.BF16_BWD_MLA_LIB if dh > k9.MAX_BWD_D else k9.BF16_BWD_LIB
    f = getattr(lib.get(), fn)
    out = [torch.empty_like(x) for x in (q, k, v)]
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse, delta, *out)]
    scale = float(np.float32(dh ** -0.5))
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = f(*ptrs, b, h, kv, s, t, dh, dv, scale, 1, vec, stream)
        if err:
            raise RuntimeError(f"{fn}: error {err}")
    return call


def _one(tree: str, keep: str, first: bool) -> dict:
    """Times the backward and the bf16 train steps with the port of
    ``tree`` (already on sys.path); keeps (first tree) or compares with the
    gradients under ``keep``."""
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
    # after the tree's port is imported, and sys.path put back: chip_smoke
    # puts this checkout's src first
    path = list(sys.path)
    from chip_smoke import ptxas_kernels, ptxas_logs
    sys.path[:] = path
    libs = [k9.BF16_BWD_LIB, k9.BF16_BWD_MLA_LIB]
    common.build([k9.BF16_LIB] + libs)
    out = {"ptxas": {}}
    for lib, log in ptxas_logs(libs).items():
        out["ptxas"][lib] = {"kernels": ptxas_kernels(log), "warnings": [
            line.strip() for line in log.splitlines() if "arning" in line]}
        for kern, (regs, st, ld) in out["ptxas"][lib]["kernels"].items():
            print(f"[bf16_bwd_ab] {tree} {lib}: {kern} {regs} registers, "
                  f"{st} bytes spill stores, {ld} bytes spill loads",
                  flush=True)
        for line in out["ptxas"][lib]["warnings"]:
            print(f"[bf16_bwd_ab] {tree} {lib}: {line}", flush=True)
    dev = torch.device("cuda")
    for i, (what, b, h, kv, s, dh, dv) in enumerate(SHAPES):
        gen = torch.Generator(device=dev).manual_seed(2900 + i)
        q = torch.randn((b, h, s, dh), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, kv, s, dh), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, kv, s, dv), generator=gen, device=dev).bfloat16()
        do = torch.randn((b, h, s, dv), generator=gen, device=dev).bfloat16()
        o, lse = k9._launch_forward(q, k, v, True, with_lse=True)
        args = (q, k, v, o, do, lse, 64, 64, True)
        grads = k9.flash_backward(*args)
        path = os.path.join(keep, f"{i}.pt")
        if first:
            torch.save([x.cpu() for x in grads], path)
            same, diff = None, None
        else:
            ref = [x.to(dev) for x in torch.load(path)]
            same = all(torch.equal(x, y) for x, y in zip(grads, ref))
            diff = [float((x.float() - y.float()).abs().max())
                    for x, y in zip(grads, ref)]
            del ref
        ms = _ms(lambda: k9.flash_backward(*args), 5)
        per = _kernel_ms(lambda: k9.flash_backward(*args))
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        y = F.scaled_dot_product_attention(*xs, is_causal=True,
                                           enable_gqa=True)
        sdpa = _ms(lambda: torch.autograd.grad(y, xs, do, retain_graph=True),
                   5)
        host = {"flash_backward": _host_ms(lambda: k9.flash_backward(*args))}
        for vec in (1, 0):
            host[f"entry vec {vec}"] = _host_ms(_entry(k9, q, k, v, o, do,
                                                       lse, vec))
        out[what] = {"bwd_ms": ms, "kernels_ms": per, "sdpa_bwd_ms": sdpa,
                     "host_ms": host, "bitwise_first_tree": same,
                     "max_diff_first_tree": diff}
        print(f"[bf16_bwd_ab] {tree} {what}: K9 bf16 backward {ms:.3f} ms ("
              + ", ".join(f"{n} {t:.4f}" for n, t in per.items())
              + f"; the kernels' sum {sum(per.values()):.4f}; the host a "
              "call, the card busy: " + ", ".join(
                  f"{n} {t:.4f}" for n, t in host.items())
              + f"), SDPA's bf16 backward {sdpa:.3f} ms" + (
                  "" if first else f"; gradients bitwise the first tree's: "
                  f"{same} (max |diff| dq, dk, dv {diff})"), flush=True)
        del q, k, v, do, o, lse, grads, xs, y
        torch.cuda.empty_cache()
    bsz, seq = 1, 4096
    for arch, layers in STEPS:
        ex = configs.exec_default(arch, "train_4k")
        cfg = dataclasses.replace(configs.get(arch), num_layers=layers,
                                  param_dtype="bfloat16", dtype="bfloat16",
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
        print(f"[bf16_bwd_ab] {tree} {arch} ({layers} layers, bf16, {bsz} x "
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
    ap.add_argument("--one", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        (tree,) = args.trees
        keep, first = args.one
        print(json.dumps(_one(tree, keep, first == "1")))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bf16_bwd_ab: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[bf16_bwd_ab] {card}", flush=True)
    here = os.path.abspath(__file__)
    keep = tempfile.mkdtemp()
    runs = []
    try:
        for i, tree in enumerate(args.trees):
            env = dict(os.environ, PYTHONPATH=os.path.join(
                os.path.abspath(tree), "src"))
            p = subprocess.run(
                [sys.executable, here, "--one", keep, str(int(i == 0)),
                 tree],
                env=env, stdout=subprocess.PIPE, text=True, check=True)
            lines = p.stdout.strip().splitlines()
            print("\n".join(lines[:-1]), flush=True)
            runs.append({"tree": tree, "times": json.loads(lines[-1])})
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "bf16_bwd_ab.json"), "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(json.dumps({"card": card, "runs": [
        {"tree": r["tree"],
         **{w: round(r["times"][w]["bwd_ms"], 3) for w in
            [x[0] for x in SHAPES]},
         **{f"{a} step_ms": round(r["times"][a]["step_ms"], 1)
            for a, _ in STEPS}}
        for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
