"""Single-card serving driver: batched prefill + greedy decode — the port
of ``repro/launch/serve.py``, with ``--device`` (CUDA unless another is
named).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --batch 4 --prompt-len 64 --max-new 32

Every arch but xlstm-1p3b is served (deepseek-v2-236b and kimi-k2-1t-a32b
through MLA and the MoE FFN).

``--smoke`` is kept as the reference has it: ``store_true`` with
``default=True``, so it cannot be turned off and the driver always
serves the arch's ``SMOKE`` config (in float32, as the reference does).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import configs as cfglib
from ..kernels.common import resolve_device
from ..models import model as model_lib
from ..serve.engine import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = cfglib.smoke_config(args.arch) if args.smoke else cfglib.get(args.arch)
    cfg = dataclasses.replace(cfg, param_dtype="float32", dtype="float32")
    model = model_lib.init(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    print(f"[serve] {cfg.name}: {model_lib.param_count(model)/1e6:.1f}M "
          f"params on {device}")

    engine = ServeEngine(model, cfg,
                         max_len=args.prompt_len + args.max_new,
                         temperature=args.temperature)
    rng = np.random.default_rng(0)
    shape = (args.batch, args.prompt_len)
    if cfg.num_codebooks > 1:
        shape = shape + (cfg.num_codebooks,)
    prompts = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)

    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.time()
    out = engine.generate(prompts, max_new=args.max_new, generator=gen)
    dt = time.time() - t0
    n_tok = out.shape[0] * out.shape[1]
    print(f"[serve] generated {out.shape} tokens in {dt:.2f}s "
          f"({n_tok/dt:.0f} tok/s incl. prefill and the kernels' build)")
    print(f"[serve] sample continuation: {out[0].reshape(out.shape[1], -1)[:8, 0]}")


if __name__ == "__main__":
    main()
