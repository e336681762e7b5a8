"""The port's sharding rules and logical-axis plumbing (M11c) against the
JAX package's: ``logical_spec`` / ``axis_divisor`` entries, ``param_specs``
(on the reference's stacked shapes, stack entries dropped) for all 13
configs on three meshes with and without FSDP, ``cache_specs`` and
``batch_specs`` at every applicable shape, the reference's own rule tests
in port form, hints that dispatch nothing without a context, and a 4-rank
``gloo`` run whose sharded train steps equal the unsharded ones."""
from __future__ import annotations

import functools
import itertools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.utils import sharding as jsharding  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.utils import sharding  # noqa: E402
from repro_torch.utils.sharding import P  # noqa: E402

ARCHS = config._ARCHS


class FakeMesh:
    """A mesh as the rules read it: axis names and sizes."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "2x2": dict(data=2, model=2)}


def _norm(spec):
    """A spec's entries as JAX normalizes them (a 1-tuple of names is the
    name)."""
    out = []
    for e in spec:
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, tuple) else e)
    return tuple(out)


# ---------------------------------------------------------------------------
# logical axis context
# ---------------------------------------------------------------------------

NAMES = [None, "batch", "model"]


@pytest.mark.parametrize("batch,model,sizes", [
    (("data",), "model", {"data": 16, "model": 16}),
    (("pod", "data"), "model", {"pod": 2, "data": 16, "model": 16}),
    (("data",), None, {"data": 4}),
    ((), "model", {"model": 8}),
    (("data",), "model", {"data": 2, "model": 2})])
def test_logical_spec_and_divisor_equal_the_reference(batch, model, sizes):
    shapes = [(64, 56, 128), (32, 16, 7), (1, 4096, 8), (6, 48, 96)]
    for names in itertools.product(NAMES, repeat=3):
        for shape in shapes + [None]:
            with jsharding.axis_ctx(batch, model, sizes):
                want = jsharding.logical_spec(*names, shape=shape)
                jdiv = {n: jsharding.axis_divisor(n) for n in ("batch",
                                                               "model")}
            with sharding.axis_ctx(batch, model, sizes):
                got = sharding.logical_spec(*names, shape=shape)
                div = {n: sharding.axis_divisor(n) for n in ("batch",
                                                             "model")}
            assert _norm(got) == tuple(want), (names, shape)
            assert div == jdiv
    assert sharding.logical_spec("batch") is None
    assert sharding.axis_divisor("model") == 1


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_constrain_noop_without_context():
    x = torch.ones((4, 4))
    with OpCount() as c:
        y = sharding.constrain(x, "batch", "model")
        z = sharding.local_elementwise(torch.neg, x)
    assert y is x and c.ops == ["aten.neg.default"]
    assert torch.equal(z, -x)
    with sharding.axis_ctx(sizes={"data": 2, "model": 2}), OpCount() as c:
        # a context without a mesh resolves specs and moves nothing
        assert sharding.constrain(x, "batch", "model") is x
    assert c.ops == []


def test_logical_spec_resolution():
    with sharding.axis_ctx(batch=("pod", "data"), model="model",
                           sizes={"pod": 2, "data": 16, "model": 16}):
        assert sharding.logical_spec("batch", None, "model") == \
            P(("pod", "data"), None, "model")
        assert sharding.axis_divisor("model") == 16
        assert sharding.axis_divisor("batch") == 32
        # divisibility fallback: 56 not divisible by 16 => replicated dim
        spec = sharding.logical_spec("batch", "model", shape=(64, 56))
        assert spec == P(("pod", "data"), None)


def _hint_free(monkeypatch):
    """Patch every hint in the models out (identity, no op)."""
    from repro_torch.models import (api, common, mamba2, transformer, whisper,
                                    xlstm, zamba)
    ident = lambda x, *names: x  # noqa: E731
    for mod in (common, mamba2, transformer, whisper, xlstm, zamba):
        if hasattr(mod, "constrain"):
            monkeypatch.setattr(mod, "constrain", ident)
    monkeypatch.setattr(common, "seq_shard", lambda x: x)
    monkeypatch.setattr(common, "axis_divisor", lambda name: 1)
    monkeypatch.setattr(common, "sharded_dim", lambda x, name: None)
    monkeypatch.setattr(common, "head_local",
                        lambda fn, args, hd, sh: fn(*args))
    monkeypatch.setattr(xlstm, "local_elementwise", lambda fn, x: fn(x))
    monkeypatch.setattr(sharding, "on_mesh", lambda x: False)
    assert api is not None


def _decode_ops(arch):
    from repro_torch.launch.serve import reduced
    cfg = reduced(config.get_arch(arch)).scaled(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.arange(8, dtype=torch.int64).reshape(2, 4) % cfg.vocab
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.zeros(
            (2, cfg.encdec.n_audio_frames, cfg.d_model))
    _, cache = model.prefill(params, batch, 8)
    with OpCount() as c:
        logits, _ = model.decode_step(params, cache, toks[:, :1], 4)
    return c.ops, logits


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "xlstm-1.3b", "zamba2-7b", "whisper-tiny"])
def test_hints_dispatch_nothing_in_a_decode_step(arch, monkeypatch):
    """Without a context the hints add no dispatched op to a decode step
    (what a captured CUDA graph replays): the op list with them equals
    the op list with every hint patched out, and so do the logits."""
    ops, logits = _decode_ops(arch)
    _hint_free(monkeypatch)
    ops_free, logits_free = _decode_ops(arch)
    assert ops == ops_free and len(ops) > 50
    assert torch.equal(logits, logits_free)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(the reference's param shapes via eval_shape, the port's fake
    params)."""
    jshapes = jax.eval_shape(jbuild(jconfig.get_arch(arch)).init,
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    return jshapes, steps.eval_params(build_model(config.get_arch(arch)))


def _ref_param_specs(arch, mesh, fsdp):
    jshapes, _ = _shapes(arch)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jsteps._spec_for(path, leaf, mesh, fsdp), jshapes)


def _pairs(port_specs, ref_specs, port_params, path=""):
    """(path, port spec, reference spec, stack depth) of every port leaf,
    the reference's leaf reached by dropping the list indices."""
    if port_params is None:
        assert ref_specs is None
        return
    if isinstance(port_params, dict):
        for k in port_params:
            yield from _pairs(port_specs[k], ref_specs[k], port_params[k],
                              f"{path}/{k}")
        return
    if isinstance(port_params, list):
        for i, (s, p) in enumerate(zip(port_specs, port_params)):
            yield from _pairs(s, ref_specs, p, f"{path}[{i}]")
        return
    yield path, port_specs, ref_specs, len(ref_specs) - port_params.ndim


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch):
    """Every leaf's spec equals the reference's on its stacked leaf with
    the stack entries dropped, on 16x16, 2x16x16 and 2x2, with and without
    FSDP; the leaves whose stacked spec put a mesh axis on a stack dim are
    exactly the ones ``stack_dim_axes`` names (replicated on that axis in
    the port)."""
    model = build_model(config.get_arch(arch))
    _, port_params = _shapes(arch)
    for (mname, sizes), fsdp in itertools.product(MESHES.items(),
                                                  (True, False)):
        mesh = FakeMesh(**sizes)
        got = steps.param_specs(model, mesh, fsdp)
        want = _ref_param_specs(arch, mesh, fsdp)
        stacked = []
        n = 0
        for path, spec, ref, depth in _pairs(got, want, port_params):
            assert isinstance(spec, P)
            assert _norm(spec) == tuple(ref)[depth:], (mname, fsdp, path)
            if any(e is not None for e in tuple(ref)[:depth]):
                stacked.append((path, tuple(ref)[:depth]))
            n += 1
        assert n > 0
        assert [(p, _norm(e)) for p, e in
                steps.stack_dim_axes(model, mesh, fsdp)] == stacked


def test_no_stack_dim_holds_a_mesh_axis():
    """No leaf differs from the reference for want of a stack dim: on the
    three meshes, with FSDP or without, the reference's stacked specs of
    all 13 configs put no mesh axis on a layer axis (FSDP walks from the
    last dim and always finds a divisible one first), so every per-layer
    leaf is sharded as the reference shards its slice."""
    for arch in ARCHS:
        model = build_model(config.get_arch(arch))
        for sizes, fsdp in itertools.product(MESHES.values(), (True, False)):
            assert steps.stack_dim_axes(model, FakeMesh(**sizes), fsdp) == []


def test_param_specs_rules():
    model = build_model(config.get_arch("qwen3-1.7b"))
    mesh = FakeMesh(data=16, model=16, pod=2)
    mesh.axis_names = ("data", "model")
    specs = steps.param_specs(model, mesh, fsdp=True)
    # wq per layer (dm, nh*dh): col-parallel + fsdp on dm (the reference's
    # stacked (L, dm, nh*dh) less its layer entry)
    assert specs["layers"][0]["attn"]["wq"] == P("data", "model")
    # wo per layer (nh*dh, dm): row-parallel on -2
    assert specs["layers"][5]["attn"]["wo"][-2] == "model"
    # embed (V, dm): col-parallel on dm, fsdp on V
    assert specs["embed"] == P("data", "model")
    no_fsdp = steps.param_specs(model, mesh, fsdp=False)
    assert no_fsdp["embed"] == P(None, "model")


def test_moe_expert_parallel_rule():
    mesh = FakeMesh(data=16, model=16)
    # granite: 32 experts % 16 == 0 => expert-parallel
    specs = steps.param_specs(
        build_model(config.get_arch("granite-moe-1b-a400m")), mesh,
        fsdp=False)
    assert specs["layers"][0]["moe"]["w1"][0] == "model"
    # mixtral: 8 experts, not divisible => hidden-dim fallback
    specs = steps.param_specs(build_model(config.get_arch("mixtral-8x22b")),
                              mesh, fsdp=False)
    assert specs["layers"][0]["moe"]["w1"] == P(None, None, "model")
    assert specs["layers"][0]["moe"]["w2"] == P(None, "model", None)


# ---------------------------------------------------------------------------
# Cache and batch rules
# ---------------------------------------------------------------------------


def test_cache_specs_batch_detection():
    """Batch (= 128) at axis 0 of the per-layer leaf and the slots at axis
    1 (the reference's stacked leaf keeps a layer axis in front, which
    the port has not: no layer count can be mistaken for the batch)."""
    mesh = FakeMesh(data=16, model=16)
    leaves = [{"k": torch.empty((128, 32768, 16, 128), device="meta")}]
    specs = steps.cache_specs(config.get_arch("olmo-1b"), mesh, leaves,
                              batch=128)
    assert _norm(specs[0]["k"]) == ("data", "model", None, None)


def test_cache_specs_b1_long_context():
    mesh = FakeMesh(data=16, model=16)
    leaves = {"k": torch.empty((1, 4096, 8, 128), device="meta")}
    specs = steps.cache_specs(config.get_arch("mixtral-8x22b"), mesh,
                              leaves, batch=1)
    assert specs["k"][1] == "model"     # slots sharded, batch replicated


# the reference's cache leaves by their stack depth: xLSTM's mLSTM states
# and Zamba2's main groups stack (G, K, ...); every other leaf one axis
_DEPTH2 = ("mlstm", "main_ssm", "main_conv")


def _ref_cache_pairs(arch, shape, mesh):
    jmodel = jbuild(jconfig.get_arch(arch))
    B = shape.global_batch
    cache = jax.eval_shape(functools.partial(jmodel.init_cache, B,
                                             shape.seq_len))
    specs = jsteps.cache_specs(jconfig.get_arch(arch), mesh, cache, batch=B)
    out = set()
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(cache)[0],
            jax.tree_util.tree_leaves(
                specs, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))):
        top = str(getattr(path[0], "key", ""))
        depth = 2 if top in _DEPTH2 else 1
        spec = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        assert all(e is None for e in spec[:depth]), (arch, path, spec)
        out.add((tuple(leaf.shape[depth:]), spec[depth:]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_the_reference(arch):
    """At every applicable shape, on 16x16 and 2x16x16: the port's
    per-layer cache leaves get the reference's specs (its stacked leaves'
    less the stack entries, matched by shape: the rule reads shapes only),
    and every input gets the reference's batch spec."""
    cfg = config.get_arch(arch)
    model = build_model(cfg)
    jmodel = jbuild(jconfig.get_arch(arch))
    for shape_name in config.applicable_shapes(cfg):
        shape = config.get_shape(shape_name)
        for mname in ("16x16", "2x16x16"):
            mesh = FakeMesh(**MESHES[mname])
            jshape = jconfig.get_shape(shape_name)
            want_b = jsteps.batch_specs(jconfig.get_arch(arch), jshape, mesh,
                                        jmodel.input_specs(jshape))
            ins = model.input_specs(shape)
            got_b = steps.batch_specs(cfg, shape, mesh, ins)
            assert {k: _norm(v) for k, v in got_b.items()} == \
                {k: tuple(v) for k, v in want_b.items()}
            if shape.kind == "train":
                continue
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     "meta")
            got = steps.cache_specs(cfg, mesh, cache,
                                    batch=shape.global_batch)
            port = {(tuple(leaf.shape), _norm(spec))
                    for d, s in zip(cache, got) for leaf, spec in
                    ((d[k], s[k]) for k in d)}
            assert port == _ref_cache_pairs(arch, jshape, mesh), \
                (shape_name, mname)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    """``Model.input_specs``: meta tensors of the reference's shapes and
    dtypes, for every applicable shape."""
    cfg = config.get_arch(arch)
    model, jmodel = build_model(cfg), jbuild(jconfig.get_arch(arch))
    for name in config.applicable_shapes(cfg):
        got = model.input_specs(config.get_shape(name))
        want = jmodel.input_specs(jconfig.get_shape(name))
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (name, k)
            assert str(v.dtype).split(".")[-1] == str(want[k].dtype), (name, k)


# ---------------------------------------------------------------------------
# A 4-rank sharded train step on the CPU
# ---------------------------------------------------------------------------


def _sharded_step_worker(rank, store_path, arch, out_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import reduced
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                             adamw_init)
    from repro_torch.train.trainer import to_batch
    from repro_torch.utils.remat import remat_scan
    from repro_torch.utils.tree import tree_leaves
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                            rank=rank, world_size=4)
    try:
        cfg = reduced(config.get_arch(arch)).scaled(dtype="float32")
        model = build_model(cfg)
        opt_cfg = AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=0)
        batch = to_batch(SyntheticLM(cfg, 8, 32).next_batch(), "cpu")

        def init():
            p = model.init(torch.Generator().manual_seed(0))
            return p, adamw_init(p)

        mesh = make_host_mesh(model=2, device_type="cpu")
        specs = steps.param_specs(model, mesh, fsdp=True)
        p0, o0 = init()
        params = steps.shardings(mesh, specs, p0)
        opt = steps.shardings(mesh, AdamWState(step=P(), mu=specs, nu=specs),
                              o0)
        bspecs = steps.batch_specs(cfg, None, mesh, batch)
        placed = steps.shardings(mesh, bspecs, batch)
        step = steps.make_train_step_fn(model, opt_cfg)
        from repro_torch.train.trainer import value_and_grad
        with steps.mesh_step(mesh), remat_scan(True):
            _, grads = value_and_grad(model.loss_fn, params, placed)
            params, opt, m = step(params, opt, placed)
        gfull = [t.full_tensor() for t in tree_leaves(grads)]
        full = [t.full_tensor() for t in tree_leaves(params)]
        loss = float(m["loss"].full_tensor())
        gnorm = float(m["grad_norm"].full_tensor())
        if rank == 0:
            p1, o1 = init()
            with remat_scan(True):
                p1, o1, m1 = steps.make_train_step_fn(model, opt_cfg)(
                    p1, o1, batch)
            errs = [float((a - b).abs().max() / b.abs().max().clamp(
                min=1e-30)) for a, b in zip(full, tree_leaves(p1))]
            p2, _ = init()
            with remat_scan(True):
                _, g1 = value_and_grad(model.loss_fn, p2, batch)
            gerrs = [float((a - b).abs().max() / b.abs().max().clamp(
                min=1e-30)) for a, b in zip(gfull, tree_leaves(g1))]
            with open(out_path, "w") as fh:
                json.dump(dict(loss=loss, ref_loss=float(m1["loss"]),
                               gnorm=gnorm, ref_gnorm=float(m1["grad_norm"]),
                               leaf_err=max(errs), grad_err=max(gerrs),
                               n_leaves=len(errs),
                               dtensor=type(tree_leaves(params)[0]).__name__),
                          fh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_sharded_train_step_equals_unsharded(arch, tmp_path):
    """Four ``gloo`` ranks on a 2 x 2 mesh (data x model), FSDP and tensor
    parallel params, the batch over data: one AdamW step of the reduced
    model (float32, remat on) equals the unsharded step from the same
    seed: loss and grad_norm within rtol 1e-5, every gradient leaf within
    1e-5 of its scale (max |g|).  The params after the step agree within
    2e-4 of their scale (max |p|), not 1e-5: AdamW's first step divides g
    by |g| + eps, so where |g| is near eps (1e-8) the float32 sums'
    different order (~2e-6 of the gradient's scale) moves the update by a
    share of lr (measured 1.6e-4 of OLMo's scale at lr 1e-3)."""
    import torch.multiprocessing as mp
    out = tmp_path / "out.json"
    mp.spawn(_sharded_step_worker, args=(str(tmp_path / "store"), arch,
                                         str(out)), nprocs=4, join=True)
    r = json.loads(out.read_text())
    assert r["dtensor"] == "DTensor" and r["n_leaves"] > 10
    assert r["loss"] == pytest.approx(r["ref_loss"], rel=1e-5)
    assert r["gnorm"] == pytest.approx(r["ref_gnorm"], rel=1e-5)
    assert r["grad_err"] <= 1e-5, r
    assert r["leaf_err"] <= 2e-4, r
