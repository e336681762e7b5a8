"""Training launcher (port of ``repro.launch.train``).

Runs the train step of ``launch/steps.py`` with the remat policy on, on a
CUDA device by default; reduced configs also train on the CPU with
``--device cpu``.  The JAX launcher's mesh waits for M11c:
``--model-parallel`` takes 1 only.

Usage:
  python -m repro_torch.launch.train --arch olmo-1b --steps 100 \
      --batch 32 --seq 256 --reduced --device cpu   # host-size run
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import get_arch
from repro_torch.launch.steps import make_train_step_fn
from repro_torch.models.api import build_model
from repro_torch.serving.engine import resolve_device
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import to_batch
from repro_torch.utils.remat import remat_scan

REDUCED = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
               d_ff=512, vocab=2048)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (host-scale smoke)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="1 only: a mesh waits for M11c")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; reduced configs also train on cpu")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        ap.error("--model-parallel: the port trains on one device; a mesh "
                 "waits for M11c")

    cfg = get_arch(args.arch)
    if args.reduced:
        red = dict(REDUCED)
        if cfg.is_moe:
            red["d_ff"] = 256
        red["n_kv_heads"] = min(cfg.n_kv_heads, red["n_heads"])
        cfg = cfg.scaled(**red)
    device = resolve_device(args.device)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    step = make_train_step_fn(model, opt_cfg)
    data = SyntheticLM(cfg, args.batch, args.seq)

    with remat_scan(True):
        params = model.init(torch.Generator(device=device).manual_seed(0))
        opt = adamw_init(params)
        t0 = time.time()
        for i in range(args.steps):
            batch = to_batch(data.next_batch(), device)
            params, opt, metrics = step(params, opt, batch)
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss={float(metrics['loss']):.4f}"
                      f" lr={float(metrics['lr']):.2e}"
                      f" ({time.time() - t0:.1f}s)")
    if args.checkpoint:
        from repro_torch.train import checkpoint as ck
        ck.save(args.checkpoint, (params, opt))
        print(f"saved {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
