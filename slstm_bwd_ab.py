"""The sLSTM scan's float32 backward and xlstm-1p3b's float32 train step,
for several trees of this repo run in turns on one card, and the
backward's chunk length swept.

Each tree is a checkout of the repo (its ``src/repro_torch`` is the port
it times).  For every tree in the order given, a process of its own
builds the tree's sLSTM and K10 kernels, then:

* times ``kernels.slstm.kernel.slstm_scan_backward`` at xlstm-1p3b's
  training layer (B 1, S 4096, D 2048) and at its prefill shape (B 4),
  float32 inputs from a seeded generator as ``chip_smoke.py`` draws them
  (r 0.02 N(0, 1), the zero state, no final-state gradients), on the
  forward kernel's own records: the mean of 20 launches by CUDA events
  after one warm-up;
* with ``--variants`` and a tree whose backward is the chunked scan
  (``K_CHUNK`` in its kernel module), builds ``csrc/slstm_bwd.cu`` once
  a variant with the named ``constexpr int`` constants replaced (its
  ``kChunk``, the phases' group sizes and blocks an SM), holds each
  build bitwise to ``slstm_scan_backward_plain(..., chunk=kChunk)`` on
  the same inputs, and times the whole backward and each of its four
  phases alone on the device (``graph_ms``: 20 calls captured in one
  CUDA graph, its replay timed by CUDA events, so the host's launch path
  is not in it; each phase on what the phases before it left in the
  scratch);
* trains xlstm-1p3b cut to 8 layers (one period: 7 mLSTM, 1 sLSTM) at
  full width in float32 (remat "full", its ``train_4k`` exec) on 1 x
  4096 tokens of the port's SyntheticCorpus, random weights from a seed:
  one warm-up step, then 3 steps timed by the host clock around
  synchronised calls (the median).

So ``python3 slstm_bwd_ab.py A B B A`` compares two trees with each
timed early and late in the call:

    python3 slstm_bwd_ab.py .dev/parent . . .dev/parent \
        --variants kChunk=64 kChunk=128,kMapGroup=4

prints one line a tree and measurement, a JSON summary last, and writes
the runs to ``chiprun_out/slstm_bwd_ab.json``.  It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

#: (what, B, S, D): the timed shapes.
SHAPES = (("training layer", 1, 4096, 2048), ("prefill shape", 4, 4096, 2048))
#: The train step: (arch, layers).
STEP = ("xlstm-1p3b", 8)
PHASES = ("maps", "carries", "replay", "dr")


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


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph (after one warm-up call), a replay timed by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _variant(ks, spec: str):
    """(kChunk, ``ks.BWD_LIB``'s source built with the constants of
    ``spec`` ("NAME=VALUE,..."), a library of its own under the build
    directory)."""
    from repro_torch.kernels import common
    consts = dict(kv.split("=") for kv in spec.split(","))
    where = os.path.join(common.BUILD_DIR, "variants")
    os.makedirs(where, exist_ok=True)
    for h in ks.BWD_LIB.headers:
        shutil.copy(h, where)
    with open(ks.BWD_LIB.source) as f:
        text = f.read()
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {int(value)};", text)
        assert n == 1, name
    tag = spec.replace("=", "").replace(",", "_")
    path = os.path.join(where, f"slstm_bwd_{tag}.cu")
    with open(path, "w") as f:
        f.write(text)
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", text).group(1))
    return chunk, common.KernelLib(
        f"slstm_bwd_{tag}", path,
        headers=tuple(os.path.join(where, os.path.basename(h))
                      for h in ks.BWD_LIB.headers),
        signatures=ks.BWD_LIB.signatures)


def _one(tree: str, specs) -> dict:
    """Times the backward (and with ``specs`` its variants) and the train
    step with the port of ``tree`` (already on sys.path)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs, models
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.kernels import common
    from repro_torch.kernels.gla import kernel as k10
    from repro_torch.kernels.slstm import kernel as ks
    from repro_torch.train import (AdamWConfig, adamw_init, cosine_schedule,
                                   make_train_step)
    chunked = hasattr(ks, "K_CHUNK")
    variants = {v: _variant(ks, v) for v in specs} if chunked else {}
    common.build([ks.LIB, ks.BWD_LIB, k10.LIB, k10.BWD_LIB]
                 + [lib for _, lib in variants.values()])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for what, b, s, d in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(2790)
        zifo = torch.randn((b, s, 4 * d), generator=gen, device=dev)
        zifo[..., 2 * d:3 * d] += 0.5
        dhs = torch.randn((b, s, d), generator=gen, device=dev)
        r = 0.02 * torch.randn((4, d), generator=gen, device=dev)
        st = [torch.zeros((b, d), device=dev) for _ in range(4)]
        hs, _, recs = ks._launch_forward(zifo, r, *st, True)
        args = (zifo, r, *st, hs, *recs, dhs, None, None, None, None)
        ms = _ms(lambda: ks.slstm_scan_backward(*args), 20)
        dev_ms = graph_ms(lambda: ks.slstm_scan_backward(*args), 20)
        row = {"bwd_ms": ms, "bwd_device_ms": dev_ms}
        print(f"[slstm_bwd_ab] {tree} {what} (B {b}, S {s}, D {d}): "
              f"backward {ms:.4f} ms (device {dev_ms:.4f})", flush=True)
        for spec, (k, lib) in variants.items():
            full = ks._launch_backward(lib, k, *args)
            plain = ks.slstm_scan_backward_plain(*args, chunk=k)
            same = all(torch.equal(x, y) for x, y in zip(full, plain))
            assert same, f"{spec}: the kernel differs from its plain version"
            k_ms = graph_ms(lambda: ks._launch_backward(lib, k, *args,
                                                        out=full), 20)
            phase = [graph_ms(lambda: ks._launch_backward(
                lib, k, *args, phases=1 << p, out=full), 20)
                for p in range(4)]
            row[spec] = {"ms": k_ms, **dict(zip(PHASES, phase))}
            print(f"[slstm_bwd_ab] {tree} {what}, {spec}: bitwise its plain "
                  f"version; device {k_ms:.4f} ms (" + ", ".join(
                      f"{n} {t:.4f}" for n, t in zip(PHASES, phase))
                  + " ms alone)", flush=True)
            del full, plain
        out[what] = row
        del zifo, dhs, hs, recs, args
        torch.cuda.empty_cache()
    arch, layers = STEP
    ex = configs.exec_default(arch, "train_4k")
    cfg = dataclasses.replace(configs.get(arch), num_layers=layers,
                              param_dtype="float32", dtype="float32",
                              remat=ex.remat)
    model = models.init(cfg, generator=torch.Generator(
        device=dev).manual_seed(27), device=dev)
    opt_cfg = AdamWConfig(lr=3e-4)
    opt = adamw_init(model, opt_cfg)
    step = make_train_step(cfg, ex, opt_cfg, lr_schedule=lambda c: (
        cosine_schedule(c, peak_lr=3e-4, warmup=20, total=100)))
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=27), 4096, 1)
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
    out[arch] = {"step_ms": ms, "steps_ms": times}
    print(f"[slstm_bwd_ab] {tree} {arch} ({layers} layers, f32, 1 x 4096): "
          f"{ms:.1f} ms a step (median of 3 after a warm-up; "
          + ", ".join(f"{t:.1f}" for t in times) + ")", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="repo checkouts, timed in "
                    "this order")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="builds of the backward to time, each NAME=VALUE,... "
                    "of its constexpr constants (chunked trees only)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        (tree,) = args.trees
        print(json.dumps(_one(tree, args.variants)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("slstm_bwd_ab: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[slstm_bwd_ab] {card}", flush=True)
    here = os.path.abspath(__file__)
    runs = []
    for tree in args.trees:
        env = dict(os.environ, PYTHONPATH=os.path.join(
            os.path.abspath(tree), "src"))
        p = subprocess.run([sys.executable, here, "--one", tree,
                            "--variants", *args.variants], env=env,
                           stdout=subprocess.PIPE, text=True, check=True)
        lines = p.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), flush=True)
        runs.append({"tree": tree, "times": json.loads(lines[-1])})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "slstm_bwd_ab.json"), "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(json.dumps({"card": card, "runs": [
        {"tree": r["tree"],
         **{w: round(r["times"][w]["bwd_ms"], 4) for w, *_ in SHAPES},
         "step_ms": round(r["times"][STEP[0]]["step_ms"], 1)}
        for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
