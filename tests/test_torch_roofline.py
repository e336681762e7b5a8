"""The port's roofline (M11b) against the JAX package's: the analytic
terms equal exactly for every assigned arch x applicable shape, and the
traced collective counter (the counterpart of the reference's HLO parser)
counts known bytes on small fake-process-group programs, once per
dispatch, so a loop of 24 counts 24 times."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.launch.dryrun import fake_group  # noqa: E402
from repro_torch.launch.mesh import _mesh  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402

CASES = [(a, s) for a in config.list_archs(assigned_only=True)
         for s in config.applicable_shapes(config.get_arch(a))]


@pytest.mark.parametrize("arch,shape", CASES)
def test_analytic_terms_equal_the_reference(arch, shape):
    cfg, jcfg = config.get_arch(arch), jconfig.get_arch(arch)
    sh, jsh = config.get_shape(shape), jconfig.get_shape(shape)
    got = analysis.analytic_costs(cfg, sh)
    want = janalysis.analytic_costs(jcfg, jsh)
    assert got == want
    assert analysis.model_flops(cfg, sh) == janalysis.model_flops(jcfg, jsh)
    for coll, chips in ((0.0, 256), (3.5e9, 512), (1e12, 1)):
        t = analysis.roofline_terms(*got, coll, chips, config.V5E)
        jt = janalysis.roofline_terms(*want, coll, chips, jconfig.V5E)
        assert t == jt
        assert analysis.dominant_term(t) == janalysis.dominant_term(jt)


def test_roofline_term_math():
    terms = analysis.roofline_terms(197e12 * 256, 819e9 * 256, 50e9 * 256,
                                    256, config.V5E)
    assert terms["t_compute"] == pytest.approx(1.0)
    assert terms["t_memory"] == pytest.approx(1.0)
    assert terms["t_collective"] == pytest.approx(1.0)
    assert analysis.dominant_term({"t_compute": 3, "t_memory": 1,
                                   "t_collective": 2}) == "t_compute"
    # the port's default hardware is the card it runs on
    h = analysis.roofline_terms(989e12, 3.35e12, 450e9, 1)
    assert h == {"t_compute": 1.0, "t_memory": 1.0, "t_collective": 1.0}


def _dt(shape, placements, mesh):
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for size, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            local[p.dim] //= size
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _traced(fn):
    """Run ``fn(mesh)`` on a fake 4-rank model axis under the tracer."""
    with fake_group(4):
        mesh = _mesh("cpu", (4,), ("model",))
        tracer = analysis.StepTracer()
        with tracer:
            fn(mesh)
    return tracer


def test_row_parallel_matmul_all_reduce():
    """x (8, 64) sharded on its contraction dim, w (64, 32) on its rows:
    the product is a partial sum, and making it whole is one all-reduce
    of the (8, 32) float32 output: 1,024 bytes a device."""
    from torch.distributed.tensor import Replicate, Shard

    def fn(mesh):
        x = _dt((8, 64), [Shard(1)], mesh)
        w = _dt((64, 32), [Shard(0)], mesh)
        y = (x @ w).redistribute(mesh, [Replicate()])
        assert tuple(y.to_local().shape) == (8, 32)

    t = _traced(fn)
    assert t.collectives == {"all-reduce": 8 * 32 * 4}
    assert t.collective_totals()["total"] == 1024 and t.n_collectives == 1


def test_all_gather():
    from torch.distributed.tensor import Replicate, Shard

    def fn(mesh):
        _dt((8, 64), [Shard(0)], mesh).redistribute(mesh, [Replicate()])

    t = _traced(fn)
    assert t.collectives == {"all-gather": 8 * 64 * 4}


def test_loop_counts_every_trip():
    """The same all-reduce 24 times in a loop counts 24 times (the
    reference multiplies a while body's collectives by its trip count;
    an eager step dispatches each)."""
    from torch.distributed.tensor import Replicate, Shard

    def fn(mesh):
        x = _dt((8, 64), [Shard(1)], mesh)
        w = _dt((64, 32), [Shard(0)], mesh)
        for _ in range(24):
            (x @ w).redistribute(mesh, [Replicate()])

    t = _traced(fn)
    assert t.collectives == {"all-reduce": 24 * 8 * 32 * 4}
    assert t.n_collectives == 24


def test_tracer_peak_and_bytes():
    """The tracer's peak counts live storages from the op that makes them
    until they are freed; in-place ops make none."""
    t = analysis.StepTracer()
    a = torch.empty((256, 256), device="meta")
    t.hold(a)
    with t:
        b = a * 2                # +256 KiB
        b.mul_(3)                # in place: nothing new
        c = b + 1                # +256 KiB
        del b
        d = c.sum()              # 4 bytes
    assert t.peak == 3 * 256 * 256 * 4
    assert t.live == 2 * 256 * 256 * 4 + 4
    assert t.traced_bytes == 256 * 256 * 4 * (2 + 2 + 2 + 1) + 4
    del c, d
