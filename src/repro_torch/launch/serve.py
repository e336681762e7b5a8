"""Serving launcher: DFTSP-scheduled epoch serving on the PyTorch model
(port of ``repro.launch.serve``).

The paper end-to-end: Poisson arrivals -> DFTSP batch selection under the
P1 constraints -> batched prefill + decode on the model, on a CUDA device
by default, with decode attention through the ``flash_decode`` kernel.
Reduced configs also run on the CPU with ``--device cpu``, where the
kernels' plain versions stand in.  The JAX launcher's ``--tpu-env`` is left
out: the port has no cost model of its own device yet.

Usage:
  python -m repro_torch.launch.serve --arch bloom-3b --epochs 5 --rate 10 \
      --quant W8A16 --device cuda
"""
from __future__ import annotations

import argparse

from repro_torch.config import get_arch
from repro_torch.core.environment import paper_env
from repro_torch.core.policy import get_policy
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.runtime import EngineExecutor, EpochRuntime

REDUCED = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
               d_ff=512, vocab=2048)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bloom-3b")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--rate", type=float, default=10.0)
    ap.add_argument("--scheduler", default="dftsp",
                    help="policy registry spec, e.g. dftsp, stb, "
                         "dftsp:d_sweep=false")
    ap.add_argument("--quant", default="W8A16",
                    help="env's deployed method; pass "
                         "--scheduler dftsp:quant=auto to let the "
                         "control plane pick the method per epoch")
    ap.add_argument("--bits", type=int, default=8,
                    help="engine's DEFAULT weight bits (0 = fp); "
                         "per-epoch decisions override via the "
                         "multi-precision weight cache")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch-capacity", type=int, default=8)
    ap.add_argument("--s-max", type=int, default=64)
    ap.add_argument("--n-max", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the kernels run on cuda, the CPU "
                         "runs their plain versions")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    env = paper_env(args.arch, args.quant)

    if args.reduced:
        red = dict(REDUCED)
        red["n_kv_heads"] = min(cfg.n_kv_heads, red["n_heads"])
        cfg = cfg.scaled(**red)
    engine = ServingEngine(cfg, batch_capacity=args.batch_capacity,
                           s_max=args.s_max, n_max=args.n_max,
                           quant_bits=args.bits,
                           device=args.device)
    runtime = EpochRuntime(env, get_policy(args.scheduler),
                           EngineExecutor(engine))
    trace = runtime.run(rate=args.rate, n_epochs=args.epochs,
                        warmup_epochs=0)
    print(f"[serve] epochs={trace.epochs} served={trace.served} "
          f"tokens={trace.generated_tokens} "
          f"truncated={trace.truncated} "
          f"throughput={trace.throughput:.2f} req/s "
          f"batches={trace.batches} "
          f"methods={trace.served_by_method}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
