"""Distributed training launcher (port of ``repro.launch.train``).

Runs the sharded train step (launch/steps.py) on the mesh the host
offers — ``make_host_mesh(model=--model-parallel)`` over the process
group's ranks, parameters placed by ``param_specs(fsdp=False)``, the step
inside the mesh's axis context, remat on — on a CUDA device by default;
reduced configs also train on the CPU with ``--device cpu``.  Under
``torchrun`` the ranks come from the environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``); otherwise the launcher is one rank, where the
mesh of one leaves the step exactly the unsharded one.

Usage:
  python -m repro_torch.launch.train --arch olmo-1b --steps 100 \
      --batch 32 --seq 256 --reduced --device cpu   # host-size run
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \
      --device cpu --model-parallel 2                # a 2 x 2 mesh
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.config import get_arch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (make_train_step_fn, mesh_step,
                                      param_specs, shardings)
from repro_torch.models.api import build_model
from repro_torch.serving.engine import resolve_device
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_init
from repro_torch.train.trainer import to_batch
from repro_torch.utils.remat import remat_scan
from repro_torch.utils.sharding import P

REDUCED = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
               d_ff=512, vocab=2048)


def _full(t):
    """A DTensor's whole value (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


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
                    help="size of the mesh's model axis; it divides the "
                         "ranks (WORLD_SIZE under torchrun, else 1)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; reduced configs also train on cpu")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.model_parallel < 1 or world % args.model_parallel:
        ap.error(f"--model-parallel {args.model_parallel} does not divide "
                 f"the {world} rank(s)")

    cfg = get_arch(args.arch)
    if args.reduced:
        red = dict(REDUCED)
        if cfg.is_moe:
            red["d_ff"] = 256
        red["n_kv_heads"] = min(cfg.n_kv_heads, red["n_heads"])
        cfg = cfg.scaled(**red)
    device = resolve_device(args.device)
    own = False
    if world > 1 and not dist.is_initialized():
        # torchrun: the ranks and the rendezvous come from the environment
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            device = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        own = True
    own |= not dist.is_initialized()
    mesh = make_host_mesh(model=args.model_parallel, device_type=device.type)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    step = make_train_step_fn(model, opt_cfg)
    pspecs = param_specs(model, mesh, fsdp=False)
    data = SyntheticLM(cfg, args.batch, args.seq)

    try:
        with mesh_step(mesh), remat_scan(True):
            params = model.init(torch.Generator(device=device).manual_seed(0))
            opt = shardings(mesh, AdamWState(step=P(), mu=pspecs, nu=pspecs),
                            adamw_init(params))
            params = shardings(mesh, pspecs, params)
            t0 = time.time()
            for i in range(args.steps):
                batch = to_batch(data.next_batch(), device)
                params, opt, metrics = step(params, opt, batch)
                if i % 10 == 0 or i == args.steps - 1:
                    print(f"step {i:5d} loss={float(_full(metrics['loss'])):.4f}"
                          f" lr={float(_full(metrics['lr'])):.2e}"
                          f" ({time.time() - t0:.1f}s)")
        if args.checkpoint:
            from repro_torch.train import checkpoint as ck
            from repro_torch.utils.tree import tree_map
            state = tree_map(_full, (params, opt))
            if dist.get_rank() == 0:
                ck.save(args.checkpoint, state)
                print(f"saved {args.checkpoint}")
    finally:
        if own:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
