"""Serving launcher: DFTSP-scheduled epoch serving on the PyTorch model
(port of ``repro.launch.serve``).

The paper end-to-end: Poisson arrivals -> DFTSP batch selection under the
P1 constraints -> batched prefill + decode on the model, on a CUDA device
by default, with decode attention through the ``flash_decode`` kernel.
Reduced configs also run on the CPU with ``--device cpu``, where the
kernels' plain versions stand in.  ``--arch`` takes every config the port
carries (``config._ARCHS``: all 13, dense, MoE, VLM, xLSTM, Zamba2 and
Whisper); ``--reduced`` cuts one to the reduced shape the test suite uses
for it (``tests/conftest.py`` ``REDUCTIONS`` and ``reduced_cfg``: 2 layers
(Zamba2 4), d_model <= 256, at most 4 experts, a sliding window of 16,
Whisper's 2 encoder layers over 32 frames), where the JAX launcher applies
one shape to every arch.  The scheduler prices a batch with the paper's
cost model (20 Jetson TX2s) by default; ``--h100-env`` prices it on the
card the port runs on (``core.environment.h100_env``), and ``--tpu-env``
on the JAX package's TPU v5e slice (a cost model only: the model still runs
on ``--device``).  The last line is the tracer's summary of the run
(``serving.trace.report``): prefill ms, decode-step ms, the card's idle
share, the captures with their ms, and the last SM clock and power.

Usage:
  python -m repro_torch.launch.serve --arch bloom-3b --epochs 5 --rate 10 \
      --quant W8A16 --device cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.config import EncDecConfig, ModelConfig, MoEConfig, \
    get_arch
from repro_torch.core.environment import h100_env, paper_env, tpu_env
from repro_torch.core.policy import get_policy
from repro_torch.serving import trace as program_trace
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.runtime import EngineExecutor, EpochRuntime

# the test suite's reduced shape of each carried arch (tests/conftest.py)
REDUCTIONS = {
    "bloom-3b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                     d_ff=512, vocab=512),
    "bloom-7b1": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                      d_ff=512, vocab=512),
    "opt-13b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                    d_ff=512, vocab=512),
    "olmo-1b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                    d_ff=256, vocab=512),
    "deepseek-coder-33b": dict(n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=2, d_ff=256, vocab=512),
    "mistral-large-123b": dict(n_layers=2, d_model=256, n_heads=8,
                               n_kv_heads=2, d_ff=512, vocab=512),
    "qwen3-1.7b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                       d_ff=256, vocab=512),
    "mixtral-8x22b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=512),
    "granite-moe-1b-a400m": dict(n_layers=2, d_model=128, n_heads=4,
                                 n_kv_heads=2, d_ff=64, vocab=512),
    "internvl2-26b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          d_ff=256, vocab=512),
    "xlstm-1.3b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       vocab=512),
    "zamba2-7b": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                      d_ff=256, vocab=512),
    "whisper-tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                         d_ff=256, vocab=512),
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` at the test suite's reduced shape: its ``REDUCTIONS``
    entry, at most 4 experts (top-k at most 2), 2 encoder layers over 32
    audio frames, a window of 16."""
    cfg = cfg.scaled(**REDUCTIONS[cfg.arch_id])
    if cfg.is_moe and cfg.moe.n_experts > 4:
        cfg = dataclasses.replace(
            cfg, moe=MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2)))
    if cfg.family == "audio":
        cfg = dataclasses.replace(
            cfg, encdec=EncDecConfig(n_enc_layers=2, n_audio_frames=32))
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=16)
    return cfg


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
    env_flag = ap.add_mutually_exclusive_group()
    env_flag.add_argument("--tpu-env", action="store_true",
                          help="use the v5e cost model instead of the "
                               "paper's")
    env_flag.add_argument("--h100-env", action="store_true",
                          help="use the H100 cost model instead of the "
                               "paper's")
    ap.add_argument("--batch-capacity", type=int, default=8)
    ap.add_argument("--s-max", type=int, default=64)
    ap.add_argument("--n-max", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the kernels run on cuda, the CPU "
                         "runs their plain versions")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    cfg = get_arch(args.arch)
    env_fn = h100_env if args.h100_env else \
        tpu_env if args.tpu_env else paper_env
    env = env_fn(args.arch, args.quant)

    if args.reduced:
        cfg = reduced(cfg)
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
    print(program_trace.report(since=t_start))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
