"""Decode-step times of the serving archs, for several trees of this repo
run in turns on one card.

Each tree is a checkout of the repo (its ``src/repro_torch`` is the port
it times).  For every round, each tree in the order given runs in a
process of its own: it builds its attention and GLA kernels, then for
each arch of ``chip_smoke.py``'s phases 23 and 24, at the same width,
depth, batch and prompt length, draws random bfloat16 weights, makes
one prefill and 16 greedy decode steps, and times them as
``chip_smoke.py``'s ``serve_full`` does: host clock around a
synchronised call, the prefill's median of 3 and the decode step's
median of 16.  So ``python3 decode_ab.py A B B A`` compares two trees
with each timed early and late in the call.

    python3 decode_ab.py .dev/parent . . .dev/parent

prints one line a tree and arch, a JSON summary last, and writes the
runs to ``chiprun_out/decode_ab.json``.  It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

#: (arch, batch, prompt tokens, new tokens, layers or None for all): the
#: serving runs of chip_smoke.py's phases 23 and 24.
CASES = (("zamba2-7b", 4, 4096, 32, None),
         ("granite-20b", 2, 4096, 16, 8),
         ("deepseek-v2-236b", 4, 4096, 32, 5),
         ("kimi-k2-1t-a32b", 2, 4096, 16, 2))


def _one(tree: str) -> dict:
    """Times every case with the port of ``tree`` (already on sys.path)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs, models
    from repro_torch.kernels import attention, common, gla
    common.build([attention.kernel.LIB, attention.kernel.BF16_LIB,
                  gla.kernel.LIB])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch, b, s, new, layers in CASES:
        over = {} if layers is None else {"num_layers": layers}
        cfg = dataclasses.replace(configs.get(arch), **over)
        gen = torch.Generator(device=dev).manual_seed(23)
        model = models.init(cfg, generator=gen, device=dev)
        toks = torch.as_tensor(np.random.default_rng(23).integers(
            0, cfg.vocab_size, size=(b, s)).astype(np.int32), device=dev)
        with torch.inference_mode():
            pre, dec = [], []
            for _ in range(3):
                cache = models.make_cache(cfg, b, s + new, concrete=True,
                                          device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                last, cache = models.prefill(model, toks, cache, cfg)
                torch.cuda.synchronize()
                pre.append(1e3 * (time.perf_counter() - t0))
            tok = last.argmax(-1)
            for i in range(16):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = models.decode_step(model, tok, cache, s + i,
                                                   cfg)
                tok = logits.argmax(-1)
                torch.cuda.synchronize()
                dec.append(1e3 * (time.perf_counter() - t0))
        out[arch] = {"prefill_ms": float(np.median(pre)),
                     "decode_ms": float(np.median(dec)), "decode_all": dec}
        print(f"[decode_ab] {tree} {arch} ({cfg.num_layers} layers, {b} x "
              f"{s}): prefill {out[arch]['prefill_ms']:.2f} ms, decode "
              f"{out[arch]['decode_ms']:.3f} ms a step (median of 16)",
              flush=True)
        del model, cache, logits, last
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
        print("decode_ab: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[decode_ab] {card}", flush=True)
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
    with open(os.path.join("chiprun_out", "decode_ab.json"), "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(json.dumps({"card": card, "decode_ms": [
        {"tree": r["tree"], **{a: round(t["decode_ms"], 3)
                               for a, t in r["times"].items()}}
        for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
