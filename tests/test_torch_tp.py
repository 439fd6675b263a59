"""PyTorch port on the CPU: the mesh's model axis (parallel/mesh.py,
the gather in models/network.py, DistributedBasecaller(n_model=),
make_train_step(mesh=)) against the JAX package on conftest's 8 virtual
CPU devices.

- ``param_pspec`` equal to JAX's for every leaf of three models at
  n_model 1, 2, 3, 4 and 8 (3 and 8 reach the replicated fallback);
- ``shard_params`` and ``shard_opt_state`` on a 2 x 4 mesh: each shard
  equal to the matching addressable shard of JAX's array, on the
  matching mesh position;
- ``transitions`` over a 2 x 4 mesh of CPU replicas within 1e-4 of JAX's
  on its 2 x 4 mesh, and bit-equal to the port's one-device run; the
  gather's backward hands each shard its own columns of the gradient;
- ``DistributedBasecaller(n_model=4).call_batch`` against JAX's with
  tests/test_parallel.py's tolerances, and ``basecall_raw_tables`` on a
  2 x 2 mesh equal to one device's records;
- a training step on ``(1, n_model)`` meshes bit-equal to one device
  (losses, parameters and Adam's moments); on ``(2, 4)`` the losses
  within 1e-5 relative of JAX's sharded step (as __graft_entry__.py
  builds it), the moments beside their shards, and the train state
  saved on one mesh shape and loaded on another.

Synthetic weights and seeded inputs only; torch on one intra-op thread.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from flappie_tpu.basecall import Basecaller as JBasecaller
from flappie_tpu.models import config as j_config
from flappie_tpu.models.network import transitions as j_transitions
from flappie_tpu.models.params import flatten, init_synthetic
from flappie_tpu.parallel import mesh as j_mesh
from flappie_tpu.parallel.pipeline import DistributedBasecaller as JDistributed
from flappie_tpu.train import trainer as j_trainer

from flappie_tpu_torch.basecall import Basecaller
from flappie_tpu_torch.models.config import get_model_config
from flappie_tpu_torch.models.network import transitions
from flappie_tpu_torch.models.params import params_to_torch
from flappie_tpu_torch.parallel import mesh as p_mesh
from flappie_tpu_torch.parallel.pipeline import DistributedBasecaller
from flappie_tpu_torch.signal.preprocess import RawTable
from flappie_tpu_torch.signal.synthetic import synthetic_adc
from flappie_tpu_torch.train import trainer

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's recurrences are
    thousands of tiny steps, faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return get_model_config("r941_native")


@pytest.fixture(scope="module")
def params():
    return init_synthetic(j_config.get_model_config("r941_native"), seed=0)


def _mesh_position(jmesh, device) -> tuple:
    r, j = np.argwhere(np.vectorize(lambda d: d == device)(jmesh.devices))[0]
    return int(r), int(j)


def _assert_placed_like_jax(tree_j, reps, jmesh, mesh):
    """Every leaf of ``reps`` (one tree a data replica) holds on each mesh
    position what JAX's array of that leaf holds there."""
    n_model = mesh.shape["model"]
    sharded = 0
    for layer in tree_j:
        for name, arr in tree_j[layer].items():
            want_spec = tuple(j_mesh.param_pspec(f"{layer}/{name}", arr.shape, n_model))
            for shard in arr.addressable_shards:
                r, j = _mesh_position(jmesh, shard.device)
                leaf = reps[r][layer][name]
                if "model" in want_spec:
                    assert isinstance(leaf, p_mesh.Sharded), (layer, name)
                    got = leaf.shards[j]
                    assert got.device == mesh.grid[r][j]
                else:
                    assert isinstance(leaf, torch.Tensor), (layer, name)
                    got = leaf
                    assert got.device == mesh.devices[r]
                np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data),
                                              err_msg=f"{layer}/{name} at ({r}, {j})")
            sharded += "model" in want_spec
    assert sharded > 0


# -- the mesh and its placement -------------------------------------------------


@pytest.mark.parametrize("model", ["r941_native", "r941_5mC", "rle_r941_native"])
@pytest.mark.parametrize("n_model", [1, 2, 3, 4, 8])
def test_param_pspec_matches_jax(model, n_model):
    shapes = {k: v.shape for k, v in flatten(
        init_synthetic(j_config.get_model_config(model), seed=0)).items()}
    got = {k: p_mesh.param_pspec(k, s, n_model) for k, s in shapes.items()}
    want = {k: tuple(j_mesh.param_pspec(k, s, n_model)) for k, s in shapes.items()}
    assert got == want
    if model == "r941_5mC" and n_model == 8:
        assert got["ff/W"] == () and got["rnn0/iW"] == (None, "model")  # 60 columns stay whole


def test_make_mesh_grid():
    """Row-major [n_data, n_model] as JAX's reshape; repeats allowed;
    n_data defaults to len(devices) // n_model."""
    devs = [f"cpu:{i}" for i in range(8)]
    mesh = p_mesh.make_mesh(2, 3, devices=devs)
    assert mesh.shape == {"data": 2, "model": 3} and len(mesh) == 2
    assert mesh.grid == ((torch.device("cpu", 0), torch.device("cpu", 1), torch.device("cpu", 2)),
                         (torch.device("cpu", 3), torch.device("cpu", 4), torch.device("cpu", 5)))
    assert mesh.devices == (torch.device("cpu", 0), torch.device("cpu", 3))
    jm = j_mesh.make_mesh(2, 3)
    assert jm.devices.shape == (2, 3)
    assert p_mesh.make_mesh(n_model=4, devices=CPU8).shape == {"data": 2, "model": 4}
    assert p_mesh.make_mesh(n_model=3, devices=CPU8).shape == {"data": 2, "model": 3}
    assert p_mesh.make_mesh(1, 4, devices=["cuda:0"] * 4).grid == ((torch.device("cuda", 0),) * 4,)
    with pytest.raises(ValueError):
        p_mesh.make_mesh(3, 3, devices=CPU8)
    with pytest.raises(ValueError):
        p_mesh.make_mesh(1, 0, devices=CPU8)
    with pytest.raises(ValueError, match="visible"):
        p_mesh.make_mesh(1, torch.cuda.device_count() + 1)


def test_shard_params_match_jax_shards(params):
    jmesh = j_mesh.make_mesh(2, 4)
    mesh = p_mesh.make_mesh(2, 4, devices=CPU8)
    jp = j_mesh.shard_params(params, jmesh)
    reps = p_mesh.shard_params(params_to_torch(params, "cpu"), mesh)
    assert isinstance(reps, p_mesh.Replicas) and reps.mesh is mesh and len(reps) == 2
    _assert_placed_like_jax(jp, reps, jmesh, mesh)
    # each shard a copy of its own, also where the devices repeat
    ptrs = [t.data_ptr() for rep in reps for layer in rep.values() for leaf in layer.values()
            for t in p_mesh.leaf_tensors(leaf)]
    assert len(set(ptrs)) == len(ptrs)
    iW = reps[1]["rnn2"]["iW"]
    assert iW.shape == (256, 1024) and [tuple(t.shape) for t in iW.shards] == [(256, 256)] * 4
    assert torch.equal(iW.gather("cpu"), torch.from_numpy(params["rnn2"]["iW"]))
    assert iW.to(torch.bfloat16).shards[2].dtype == torch.bfloat16


def test_shard_opt_state_matches_jax(params):
    """Adam's moments placed like their parameters, the count replicated."""
    rng = np.random.default_rng(3)
    moments = {name: {layer: {k: rng.normal(size=v.shape).astype(np.float32)
                              for k, v in d.items()} for layer, d in params.items()}
               for name in ("mu", "nu")}
    state = optax.adam(1e-4).init(params)
    state = (state[0]._replace(count=jnp.asarray(5, jnp.int32), mu=moments["mu"],
                               nu=moments["nu"]),) + tuple(state[1:])
    jmesh = j_mesh.make_mesh(2, 4)
    mesh = p_mesh.make_mesh(2, 4, devices=CPU8)
    js = j_mesh.shard_opt_state(state, jmesh)
    ps = p_mesh.shard_opt_state({"count": 5, **moments}, mesh)
    assert len(ps) == 2 and all(s["count"] == 5 for s in ps)
    for name in ("mu", "nu"):
        _assert_placed_like_jax(getattr(js[0], name), [s[name] for s in ps], jmesh, mesh)


# -- the forward --------------------------------------------------------------------


def _rows(mesh, reps, fn, *arrays):
    """fn(replica tree, *row shards) on each data replica, concatenated."""
    parts = p_mesh.shard_batch(mesh, *arrays)
    return torch.cat([fn(reps[i], *(p[i] for p in parts)) for i in range(len(parts[0]))])


def test_transitions_2x4_mesh(cfg, params):
    """tests/test_parallel.py:80-95's contract (1e-4 of JAX's 2 x 4 run)
    and one device's bits."""
    rng = np.random.default_rng(2)
    B, T = 4, 256
    sig = rng.normal(size=(B, T)).astype(np.float32)
    lengths = np.array([T, T - 37, 200, T], np.int32)
    jmesh = j_mesh.make_mesh(2, 4)
    with jmesh:
        jp = j_mesh.shard_params(params, jmesh)
        s, l = j_mesh.shard_batch(jmesh, jnp.asarray(sig), jnp.asarray(lengths))
        want, _ = j_transitions(jp, j_config.get_model_config("r941_native"), s, l)
    mesh = p_mesh.make_mesh(2, 4, devices=CPU8)
    tp = params_to_torch(params, "cpu")
    reps = p_mesh.shard_params(tp, mesh)
    with torch.inference_mode():
        got = _rows(mesh, reps, lambda p, x, n: transitions(p, cfg, x, n)[0], sig, lengths)
        solo, _ = transitions(tp, cfg, torch.from_numpy(sig), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert torch.equal(got, solo)


def test_gather_backward_hands_each_shard_its_columns():
    mesh = p_mesh.make_mesh(1, 4, devices=["cpu"] * 4)
    full = torch.arange(24.0).reshape(3, 8)
    leaf = p_mesh.shard_params({"ff": {"W": full}}, mesh)[0]["ff"]["W"]
    for t in leaf.shards:
        t.requires_grad_()
    weight = torch.linspace(-1, 1, 24).reshape(3, 8)
    (p_mesh.whole({"W": leaf}, "cpu")["W"] * weight).sum().backward()
    for j, t in enumerate(leaf.shards):
        assert torch.equal(t.grad, weight[:, 2 * j : 2 * j + 2])
    plain = {"W": full}
    assert p_mesh.whole(plain, "cpu") is plain


# -- the basecaller -------------------------------------------------------------


def test_distributed_basecaller_n_model_matches_jax(cfg, params):
    """test_parallel.py:113-131 with n_model=4: B=5 rows over two data
    replicas of four model devices each."""
    rng = np.random.default_rng(4)
    B, T = 5, 2048
    sig = rng.normal(size=(B, T)).astype(np.float32)
    lengths = np.array([T, T - 100, T - 999, 1500, 1111], np.int32)
    jcfg = j_config.get_model_config("r941_native")
    want = JDistributed(jcfg, params=params, compute_trace=False, n_model=4).call_batch(sig,
                                                                                        lengths)
    caller = DistributedBasecaller(cfg, params=params, compute_trace=False,
                                   mesh=p_mesh.make_mesh(n_model=4, devices=CPU8))
    try:
        assert caller.mesh.shape == {"data": 2, "model": 4}
        assert isinstance(caller.replicas[1]["rnn0"]["sW"], p_mesh.Sharded)
        got = caller.call_batch(sig, lengths)
    finally:
        caller.close()
    solo = Basecaller(cfg, params=params, compute_trace=False, device="cpu").call_batch(sig,
                                                                                       lengths)
    for x, y, s, name in zip(want, got, solo, ["score", "path", "qpath", "nblocks", "trace"]):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if name == "qpath":
            np.testing.assert_allclose(x[:, 1:], y[:, 1:], rtol=1e-4, atol=1e-4)
        elif x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)
        np.testing.assert_array_equal(y, s, err_msg=name)  # one device's bytes


def test_distributed_basecaller_2x2_records_and_wire_log(cfg, params):
    """basecall_raw_tables on a 2 x 2 mesh: one device's records in input
    order; a dispatch's ``devices`` counts data shards x model devices."""
    rng = np.random.default_rng(8)
    raws = []
    for k, n in enumerate([2600, 3900, 3100]):
        adc = synthetic_adc(n, rng)
        raw = ((adc.astype(np.float32) + np.float32(4.0)) * np.float32(0.18)).astype(np.float32)
        raws.append(RawTable(f"read-{k}", n, 0, n, raw, adc=adc,
                             cal=(np.float32(4.0), np.float32(0.18))))
    want = Basecaller(cfg, params=params, device="cpu").basecall_raw_tables(raws)
    caller = DistributedBasecaller(cfg, params=params,
                                   mesh=p_mesh.make_mesh(2, 2, devices=["cpu"] * 4))
    try:
        got = caller.basecall_raw_tables(raws)
        log = list(caller.wire_log)
    finally:
        caller.close()
    assert [r.uuid for r in got] == ["read-0", "read-1", "read-2"]
    for a, b in zip(got, want):
        assert (a.basecall, a.quality, a.score, a.nblock) == (b.basecall, b.quality, b.score,
                                                              b.nblock)
        np.testing.assert_array_equal(a.trace, b.trace)
    assert [(rec["devices"], rec["shard_rows"]) for rec in log] == [(4, [2, 1])]


# -- training -------------------------------------------------------------------


def _step_runs(cfg, params, mesh, steps=2, B=3, T=500, lr=2e-4):
    step, init = trainer.make_train_step(cfg, lr=lr, mesh=mesh)
    # a copy: on the CPU the one-device tensors share the numpy arrays' memory
    params = {layer: {k: v.copy() for k, v in d.items()} for layer, d in params.items()}
    p, opt = init(params) if mesh is not None else init(params, device="cpu")
    batch = [torch.from_numpy(a) for a in trainer.synthetic_batch(cfg, B, T, seed=1)]
    losses = [step(p, opt, *batch) for _ in range(steps)]
    return p, opt, losses


def _whole_state(p, opt) -> dict:
    """{key: (parameter, exp_avg, exp_avg_sq)} of a run's first tree, whole."""
    tree = p[0] if isinstance(p, p_mesh.Replicas) else p
    out = {}
    for key, leaf in trainer.tree_leaves(tree):
        ts = p_mesh.leaf_tensors(leaf)
        out[key] = tuple(torch.cat([(t if m is None else opt.state[t][m]).detach() for t in ts],
                                   dim=-1) for m in (None, "exp_avg", "exp_avg_sq"))
    return out


@pytest.mark.parametrize("n_model", [2, 4])
def test_train_step_1xN_equals_one_device(cfg, params, n_model):
    mesh = p_mesh.make_mesh(1, n_model, devices=["cpu"] * n_model)
    p1, o1, l1 = _step_runs(cfg, params, None)
    pm, om, lm = _step_runs(cfg, params, mesh)
    assert [x.item() for x in l1] == [x.item() for x in lm]
    a, b = _whole_state(p1, o1), _whole_state(pm, om)
    assert a.keys() == b.keys()
    for key in a:
        for x, y in zip(a[key], b[key]):
            assert torch.equal(x, y), key
    assert trainer._adam_count(pm, om) == 2


def test_train_step_2x4_matches_jax_and_state_crosses_meshes(cfg, params, tmp_path):
    """The 2 x 4 step against JAX's sharded step (__graft_entry__.py:
    79-95): losses within 1e-5 relative, Adam's moments model-sharded in
    both; the state saved on 2 x 4 loads on one device and on 1 x 2."""
    jcfg = j_config.get_model_config("r941_native")
    B, T, steps = 4, 500, 2
    sig, lens, path = trainer.synthetic_batch(cfg, B, T, seed=1)
    jmesh = j_mesh.make_mesh(2, 4)
    jstep, jopt = j_trainer.make_train_step(jcfg)
    with jmesh:
        jp = j_mesh.shard_params(params, jmesh)
        js = j_mesh.shard_opt_state(jopt.init(params), jmesh)
        batch = j_mesh.shard_batch(jmesh, jnp.asarray(sig), jnp.asarray(lens),
                                   jnp.asarray(path))
        jl = []
        for _ in range(steps):
            jp, js, loss = jstep(jp, js, *batch)
            jl.append(float(loss))
    assert tuple(js[0].mu["rnn0"]["iW"].sharding.spec) == (None, "model")

    mesh = p_mesh.make_mesh(2, 4, devices=CPU8)
    pm, om, lm = _step_runs(cfg, params, mesh, steps=steps, B=B, T=T, lr=1e-4)
    np.testing.assert_allclose([x.item() for x in lm], jl, rtol=1e-5)
    for rep, row in zip(pm, mesh.grid):
        for j, t in enumerate(rep["rnn0"]["iW"].shards):
            st = om.state[t]
            assert st["exp_avg"].shape == t.shape == (256, 256)
            assert st["exp_avg"].device == row[j]
    # the replicas took the same steps
    for (key, a), (_, b) in zip(trainer.tree_leaves(pm[0]), trainer.tree_leaves(pm[1])):
        for x, y in zip(p_mesh.leaf_tensors(a), p_mesh.leaf_tensors(b)):
            assert torch.equal(x, y), key

    saved = tmp_path / "mesh.npz"
    trainer.save_train_state(str(saved), pm, om, steps)
    want = _whole_state(pm, om)
    step1, init1 = trainer.make_train_step(cfg, lr=1e-4)
    q, qo = init1(init_synthetic(jcfg, seed=9), device="cpu")
    _, _, k = trainer.load_train_state(str(saved), q, qo)
    assert k == steps and trainer._adam_count(q, qo) == steps
    got = _whole_state(q, qo)
    for key in want:
        for x, y in zip(want[key], got[key]):
            assert torch.equal(x, y), key

    # and back: the one-device state into a 1 x 2 mesh, which resumes
    # exactly as the one-device run does
    solo = tmp_path / "solo.npz"
    trainer.save_train_state(str(solo), q, qo, k)
    step2, init2 = trainer.make_train_step(cfg, lr=1e-4, mesh=p_mesh.make_mesh(
        1, 2, devices=["cpu"] * 2))
    r, ro = init2(init_synthetic(jcfg, seed=11))
    trainer.load_train_state(str(solo), r, ro)
    assert isinstance(r[0]["ff"]["W"], p_mesh.Sharded)
    batch = [torch.from_numpy(a) for a in (sig, lens, path)]
    assert step1(q, qo, *batch).item() == step2(r, ro, *batch).item()
    got, want = _whole_state(r, ro), _whole_state(q, qo)
    for key in want:
        for x, y in zip(want[key], got[key]):
            assert torch.equal(x, y), key
