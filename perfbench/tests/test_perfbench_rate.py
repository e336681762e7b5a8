"""The mixes' rate fills every batch: under the cells' cost model
(``h100_env``, W8A16) DFTSP picks 8 or more requests in every epoch, so
the engine serves full batches of B = 8 and the work of a run does not
depend on its seed.  (At 20 requests/s, 4-7 % of epochs picked fewer.)
Checked with the program's analytic data plane, on the harness's own
traffic generator."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import bench  # noqa: E402
from perfbench.harness.traffic import PoissonTraffic  # noqa: E402


@pytest.mark.parametrize("cell", ["bloom3b-w8a16-epoch",
                                  "bloom7b1-w8a16-epoch"])
def test_epochs_fill_the_batch(cell):
    from repro_torch.core.environment import h100_env
    from repro_torch.serving.runtime import AnalyticExecutor, EpochRuntime
    c = bench.load_cell(cell)
    env = h100_env(c["config"]["arch"], c["config"]["env"]["method"])
    B = c["config"]["engine"]["batch_capacity"]
    for seed in (3, 2 ** 31 + 7, 4_000_000_007):
        rt = EpochRuntime(env, c["traffic"]["policy"], AnalyticExecutor())
        m = rt.run(gen=PoissonTraffic(c["traffic"]["arrivals"], seed),
                   n_epochs=30, warmup_epochs=1)
        assert min(m.batch_sizes) >= B, np.bincount(m.batch_sizes)


def test_continuous_mix_admits_mid_epoch():
    from repro_torch.core.environment import h100_env
    from repro_torch.serving.runtime import (AnalyticContinuousExecutor,
                                             ContinuousRuntime)
    c = bench.load_cell("bloom3b-w8a16-continuous")
    env = h100_env(c["config"]["arch"], c["config"]["env"]["method"])
    rt = ContinuousRuntime(env, c["traffic"]["policy"],
                           AnalyticContinuousExecutor(capacity=8),
                           k=c["traffic"]["runtime"]["k"])
    m = rt.run(gen=PoissonTraffic(c["traffic"]["arrivals"], 11), n_epochs=20)
    assert m.served > 0 and m.admitted_mid_epoch > m.served // 2
