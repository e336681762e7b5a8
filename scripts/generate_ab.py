#!/usr/bin/env python3
"""Time ``generate`` (the device loop) on full-width BLOOM-3B and
qwen3-1.7b at W8A16, for several checkouts in turns on one NVIDIA GPU, so
that two versions of the port are compared inside one run on one card.

Run from the root of a checkout:

    python3 scripts/generate_ab.py build/parent,.,.,build/parent

Each entry runs in a process of its own with ``<tree>/src`` first on the
path (its kernels are built into ``<tree>/build``).  For each model it
builds a W8 engine (random weights from seed 0, B = 8, s' = 512, n_max =
128), serves one batch of 512-token prompts with caps n_max to capture the
loop, then times five more ``generate`` calls (host clock around work that
ends in a synchronize) and one prefill; ms a step is (least ``generate`` -
prefill) / 128.  Prints one line per entry and writes them all to
``build/generate_ab.json``.
"""
import json
import os
import subprocess
import sys

ENTRY = r'''
import gc, json, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.config import get_arch
from repro_torch.serving.engine import ServingEngine
out = {}
for arch in ("bloom-3b", "qwen3-1.7b"):
    eng = ServingEngine(get_arch(arch), quant_bits=8, seed=0, batch_capacity=8,
                        s_max=512, n_max=128, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 1000, size=512).tolist() for _ in range(8)]
    caps = [128] * 8
    eng.generate(prompts, caps)
    ms = []
    for _ in range(5):
        torch.cuda.synchronize(); t0 = time.perf_counter()
        eng.generate(prompts, caps)
        torch.cuda.synchronize(); ms.append((time.perf_counter() - t0) * 1e3)
    params = eng.params_for(8)
    tok = eng._prepare(prompts, caps, 8)[1][:, :512].to("cuda")
    eng._prefill(params, tok); torch.cuda.synchronize()
    t0 = time.perf_counter(); eng._prefill(params, tok); torch.cuda.synchronize()
    pre = (time.perf_counter() - t0) * 1e3
    out[arch] = dict(generate_ms=ms, prefill_ms=pre,
                     ms_per_step=(min(ms) - pre) / 128)
    del eng; gc.collect(); torch.cuda.empty_cache()
print("RESULT", json.dumps(out), flush=True)
'''


def main(trees: str) -> int:
    res = []
    for tree in trees.split(","):
        r = subprocess.run([sys.executable, "-c", ENTRY, tree],
                           capture_output=True, text=True)
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT")]
        if not line:
            print(f"{tree}: failed\n{r.stderr[-2000:]}", flush=True)
            return 1
        print(tree, line[0][7:], flush=True)
        res.append((tree, json.loads(line[0][7:])))
    os.makedirs("build", exist_ok=True)
    with open("build/generate_ab.json", "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "."))
