"""The port's device meshes and collectives against the JAX package's.

Meshes are built over the conftest's 8 virtual CPU devices on the JAX side
and over a grid of CPU entries on the port's side; each replica's piece is
held to the JAX array's shard on the device at the same grid position.
The collectives have no JAX counterpart module (the partitioner inserts
them), so they are held to their definitions and their gradients to the
transposed collective; the mesh-sharded batch norm is held to the
single-device batch norm over the whole batch, forward and backward.
"""

from __future__ import annotations

import threading

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from katib_tpu.parallel import mesh as jmesh
from katib_tpu_torch.nas.darts.ops import batch_norm
from katib_tpu_torch.parallel import collectives as C
from katib_tpu_torch.parallel import mesh as tmesh

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

AXES = [
    {"data": 8},
    {"data": 2, "model": 2},
    {"data": 2, "seq": 4},
    {"data": -1, "model": 2},
    {"trial": 4, "data": 2},
]


def _cpu(n):
    return ["cpu"] * n


@pytest.mark.parametrize("axes", AXES)
def test_make_mesh_sizes_match_jax(axes):
    n = 8 if -1 in axes.values() else int(np.prod(list(axes.values())))
    want = jmesh.make_mesh(axes, devices=jax.devices()[:n])
    got = tmesh.make_mesh(axes, devices=_cpu(n))
    assert dict(got.shape) == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    for axis in got.shape:
        assert tmesh.local_mesh_size(got, axis) == jmesh.local_mesh_size(want, axis)


@pytest.mark.parametrize("axes, n", [({"data": -1, "model": -1}, 8), ({"data": 3}, 8),
                                     ({"data": -1, "model": 3}, 8)])
def test_make_mesh_errors_match_jax(axes, n):
    with pytest.raises(ValueError):
        jmesh.make_mesh(axes, devices=jax.devices()[:n])
    with pytest.raises(ValueError):
        tmesh.make_mesh(axes, devices=_cpu(n))


def test_make_mesh_without_devices_takes_distinct_gpus_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPUs"):
        tmesh.make_mesh({"data": 2})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="asks for 4 GPUs and 2 are visible"):
        tmesh.make_mesh({"data": 2, "model": 2})
    mesh = tmesh.make_mesh({"data": -1})
    assert mesh.entries == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.route == "peer copies"
    assert tmesh.make_mesh({"data": 2}, devices=["cpu"] * 2).route == "shared device"


@pytest.mark.parametrize("axes", [{"data": 2, "model": 2}, {"data": 4}, {"model": 2, "data": 2},
                                  {"data": 2, "seq": 2}])
def test_shard_batch_pieces_are_the_jax_shards(axes):
    n = int(np.prod(list(axes.values())))
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    jm = jmesh.make_mesh(axes, devices=jax.devices()[:n])
    tm = tmesh.make_mesh(axes, devices=_cpu(n))
    jx = jmesh.shard_batch(x, jm)
    shards = {s.device: np.asarray(s.data) for s in jx.addressable_shards}
    tx = tmesh.shard_batch(x, tm)
    assert tx.placement.axis == "data" and tuple(tx.shape) == x.shape
    for r, dev in enumerate(jm.devices.flat):
        np.testing.assert_array_equal(tx.pieces[r].numpy(), shards[dev])
    np.testing.assert_array_equal(tx.full().numpy(), x)
    rep = tmesh.replicate({"w": torch.ones(3)}, tm)["w"]
    jrep = jmesh.replicate({"w": np.ones(3, np.float32)}, jm)["w"]
    assert len(rep.pieces) == len(jrep.addressable_shards) == n
    with pytest.raises(ValueError):
        tmesh.shard_batch(np.zeros((3, 2)), tm)


def test_trial_helpers_match_jax():
    for axes, n in (({"trial": 4}, 4), ({"trial": 2, "data": 2}, 4), ({"data": 4}, 4),
                    ({"data": 2, "model": 2}, 4), ({"data": 2, "seq": 2}, 4)):
        jm = jmesh.make_mesh(axes, devices=jax.devices()[:n])
        tm = tmesh.make_mesh(axes, devices=_cpu(n))
        assert tmesh.needs_safe_conv(tm) == jmesh.needs_safe_conv(jm), axes
        assert tmesh.trial_axis_size(tm) == jmesh.trial_axis_size(jm)
        for k in (1, 3, 5, 8):
            assert tmesh.padded_cohort_size(k, tm) == jmesh.padded_cohort_size(k, jm)
        js, ts = jmesh.serial_mesh(jm), tmesh.serial_mesh(tm)
        assert (js is None) == (ts is None)
        if ts is not None:
            assert dict(ts.shape) == dict(js.shape)
    assert tmesh.needs_safe_conv(None) is jmesh.needs_safe_conv(None) is False
    assert tmesh.serial_mesh(None) is None
    for axes, survivors in (({"trial": 4}, 3), ({"trial": 4, "data": 2}, 5), ({"trial": 2}, 2),
                            ({"data": 4}, 2), ({"trial": 4, "data": 2}, 1)):
        n = int(np.prod(list(axes.values())))
        jm = jmesh.make_mesh(axes, devices=jax.devices()[:n])
        tm = tmesh.make_mesh(axes, devices=_cpu(n))
        jn = jmesh.narrowed_trial_mesh(jm, jax.devices()[:survivors])
        tn = tmesh.narrowed_trial_mesh(tm, _cpu(survivors))
        assert (jn is None) == (tn is None), (axes, survivors)
        if tn is not None:
            assert dict(tn.shape) == dict(jn.shape)
    members = tmesh.shard_members({"w": torch.arange(8.0).reshape(4, 2)},
                                  tmesh.make_mesh({"trial": 2}, devices=_cpu(2)))["w"]
    assert members.placement.axis == "trial"
    assert [p.tolist() for p in members.pieces] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]


# -- collectives ---------------------------------------------------------------


MESH = tmesh.make_mesh({"data": 2, "seq": 2, "model": 2}, devices=_cpu(8))


def _values(shape=(2, 4), seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, generator=g, requires_grad=True) for _ in range(MESH.size)]


def _cotangents(outs, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=g) for o in outs]


def _grads(outs, xs, cts):
    return torch.autograd.grad(outs, xs, cts)


def test_groups_vary_only_along_their_axes():
    for axis in ("data", "seq", "model"):
        for group in MESH.groups(axis):
            coords = [{a: MESH.coord(i, a) for a in MESH.shape} for i in group]
            assert [c[axis] for c in coords] == list(range(MESH.axis_size(axis)))
            for a in MESH.shape:
                if a != axis:
                    assert len({c[a] for c in coords}) == 1
    assert sorted(sum(MESH.groups(("data", "model")), [])) == list(range(8))


def test_broadcast_and_reduce_to_home_are_transposes():
    x = torch.randn(3, requires_grad=True)
    outs = C.broadcast(x, MESH)
    assert all(torch.equal(o, x) for o in outs)
    cts = _cotangents(outs)
    (g,) = _grads(outs, [x], cts)
    torch.testing.assert_close(g, sum(cts), rtol=0, atol=1e-6)
    xs = _values((3,))
    total = C.reduce_to_home(xs, MESH)
    torch.testing.assert_close(total, sum(x.detach() for x in xs))
    ct = torch.randn(3)
    for gx in _grads([total], xs, [ct]):
        torch.testing.assert_close(gx, ct)


@pytest.mark.parametrize("axes", ["data", "seq", ("data", "model")])
def test_all_reduce_sums_each_group_and_its_gradient_is_an_all_reduce(axes):
    xs = _values()
    outs = C.all_reduce(xs, MESH, axes)
    cts = _cotangents(outs)
    grads = _grads(outs, xs, cts)
    for group in MESH.groups(axes):
        want = sum(xs[i].detach() for i in group)
        want_g = sum(cts[i] for i in group)
        for i in group:
            torch.testing.assert_close(outs[i], want)
            torch.testing.assert_close(grads[i], want_g)


def test_all_gather_concatenates_in_axis_order_and_scatters_the_gradient():
    xs = _values()
    outs = C.all_gather(xs, MESH, "seq", dim=1)
    cts = _cotangents(outs)
    grads = _grads(outs, xs, cts)
    for group in MESH.groups("seq"):
        for i in group:
            torch.testing.assert_close(outs[i], torch.cat([xs[j].detach() for j in group], 1))
        for p, j in enumerate(group):
            want = sum(cts[i][:, p * 4:(p + 1) * 4] for i in group)
            torch.testing.assert_close(grads[j], want)


def test_all_to_all_matches_jax_tiled_semantics_and_is_its_own_transpose():
    xs = _values((2, 4, 6))
    outs = C.all_to_all(xs, MESH, "seq", split_dim=1, concat_dim=2)
    for group in MESH.groups("seq"):
        for p, i in enumerate(group):
            want = torch.cat([xs[m].detach().chunk(2, dim=1)[p] for m in group], dim=2)
            torch.testing.assert_close(outs[i], want)
    cts = _cotangents(outs)
    grads = _grads(outs, xs, cts)
    back = C.all_to_all(cts, MESH, "seq", split_dim=2, concat_dim=1)
    for g, b in zip(grads, back):
        torch.testing.assert_close(g, b)
    with pytest.raises(ValueError, match="split"):
        C.all_to_all(_values((2, 3)), MESH, "seq", split_dim=1, concat_dim=0)


@pytest.mark.parametrize("shift", [1, -1])
def test_ppermute_rotates_and_its_gradient_rotates_back(shift):
    xs = _values()
    outs = C.ppermute(xs, MESH, "data", shift)
    for group in MESH.groups("data"):
        n = len(group)
        for p, i in enumerate(group):
            torch.testing.assert_close(outs[group[(p + shift) % n]], xs[i].detach())
    cts = _cotangents(outs)
    grads = _grads(outs, xs, cts)
    for g, b in zip(grads, C.ppermute(cts, MESH, "data", -shift)):
        torch.testing.assert_close(g, b)


def test_exchange_runs_each_collective_once_in_the_replicas():
    mesh = tmesh.make_mesh({"data": 4}, devices=_cpu(4))
    calls = []

    def op(values):
        calls.append(len(values))
        return [v * 10 for v in values]

    out = mesh.run(lambda r: C.exchange(torch.tensor(float(r)), op))
    assert [float(o) for o in out] == [0.0, 10.0, 20.0, 30.0] and calls == [4]
    assert [float(o) for o in mesh.run(lambda r: C.replica_all_reduce(torch.tensor(1.0), "data"))] == [4.0] * 4
    with pytest.raises(RuntimeError, match="inside a replica"):
        C.exchange(torch.zeros(()), op)


def test_a_failing_replica_releases_the_others_and_the_runner_recovers():
    mesh = tmesh.make_mesh({"data": 3}, devices=_cpu(3))

    def fn(r):
        if r == 1:
            raise KeyError("replica 1")
        return C.replica_all_reduce(torch.ones(()), "data")

    with pytest.raises(KeyError, match="replica 1"):
        mesh.run(fn)
    assert [float(x) for x in mesh.run(lambda r: C.replica_all_reduce(torch.ones(()), "data"))] == [3.0] * 3
    assert C.current_replica() is None and threading.current_thread().name == "MainThread"


@pytest.mark.parametrize("axes", [{"data": 4}, {"data": 2, "model": 2}, {"model": 2}])
def test_mesh_batch_norm_is_the_global_batch_norm(axes):
    n = int(np.prod(list(axes.values())))
    mesh = tmesh.make_mesh(axes, devices=_cpu(n))
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(8, 5, 4, 4, generator=g) * 3 + 2).requires_grad_(True)
    ct = torch.randn(8, 5, 4, 4, generator=g)
    want = F.batch_norm(x, None, None, training=True, eps=1e-5)
    (want_g,) = torch.autograd.grad(want, x, ct)
    placed = tmesh.shard_batch((x, ct), mesh)
    outs = mesh.run(lambda r: batch_norm(placed[0].pieces[r]))
    rows = [grp[0] for grp in zip(*mesh.groups("data"))]
    got = torch.cat([outs[r] for r in rows])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # every replica's output counts once per data chunk: weight the model
    # replicas of a chunk equally
    per_chunk = mesh.size // mesh.axis_size("data")
    loss = sum((outs[r] * placed[1].pieces[r]).sum() / per_chunk for r in range(mesh.size))
    (got_g,) = torch.autograd.grad(loss, x)
    torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-5)


# -- the mesh through the registry and the orchestrator -------------------------


def test_mesh_signature_is_the_jax_registrys_key():
    from katib_tpu.compile import registry as jreg
    from katib_tpu_torch.compile import registry as treg

    for axes in ({"data": 2}, {"data": 2, "model": 2}, {"data": 2, "seq": 2}, {"trial": 1}):
        n = int(np.prod(list(axes.values())))
        want = jreg.mesh_signature(jmesh.make_mesh(axes, devices=jax.devices()[:n]))
        assert treg.mesh_signature(tmesh.make_mesh(axes, devices=_cpu(n))) == want
    assert treg.mesh_signature(None) == jreg.mesh_signature(None) == ""
    with pytest.raises(NotImplementedError, match="9b"):
        treg.mesh_signature(tmesh.make_mesh({"trial": 2}, devices=_cpu(2)))


def _spec(package, train_fn, command=None, name="mesh-orch"):
    types = package.core.types
    return types.ExperimentSpec(
        name=name,
        algorithm=types.AlgorithmSpec(name="random"),
        objective=types.ObjectiveSpec(type=types.ObjectiveType.MAXIMIZE,
                                      objective_metric_name="accuracy"),
        parameters=[types.ParameterSpec("x", types.ParameterType.DOUBLE,
                                        types.FeasibleSpace(min=0.0, max=1.0))],
        max_trial_count=2,
        parallel_trial_count=1,
        train_fn=train_fn,
        command=command,
    )


@pytest.mark.parametrize("engine", ["1", "0"])
def test_orchestrator_builds_the_configured_mesh_for_every_trial(engine, tmp_path, monkeypatch):
    """The config's ``mesh_axes`` reach every trial as ``ctx.mesh`` under
    the async engine and the sync loop, as in the JAX orchestrator (here over
    CPU entries, there over the first devices)."""
    import katib_tpu
    import katib_tpu.core.types  # noqa: F401
    import katib_tpu_torch
    import katib_tpu_torch.core.types  # noqa: F401
    from katib_tpu.core.config import KatibConfig as JKatibConfig
    from katib_tpu.orchestrator import Orchestrator as JOrchestrator
    from katib_tpu_torch.core.config import KatibConfig
    from katib_tpu_torch.orchestrator.orchestrator import Orchestrator

    monkeypatch.setenv("KATIB_ASYNC_ORCH", engine)
    doc = {"init": {"mesh_axes": {"data": 2, "model": 2}}}
    shapes = {"jax": [], "port": []}

    def trainer(key):
        def train(ctx):
            shapes[key].append(dict(ctx.mesh.shape))
            ctx.report(accuracy=float(ctx.params["x"]), step=0)
        return train

    JOrchestrator(config=JKatibConfig.from_dict(doc), workdir=str(tmp_path / "j")).run(
        _spec(katib_tpu, trainer("jax")))
    exp = Orchestrator(config=KatibConfig.from_dict(doc), workdir=str(tmp_path / "t"),
                       device="cpu").run(_spec(katib_tpu_torch, trainer("port")))
    assert exp.condition.value == "MaxTrialsReached"
    assert shapes["port"] == shapes["jax"] == [{"data": 2, "model": 2}] * 2


def test_a_trial_axis_mesh_raises_and_a_black_box_one_is_refused_as_in_jax(tmp_path):
    import katib_tpu_torch
    import katib_tpu_torch.core.types  # noqa: F401
    from katib_tpu_torch.orchestrator.orchestrator import Orchestrator

    trial_mesh = tmesh.make_mesh({"trial": 2, "data": 2}, devices=_cpu(4))
    orch = Orchestrator(mesh=trial_mesh, workdir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="black-box"):
        orch.run(_spec(katib_tpu_torch, None, command=["true"], name="bb"))
    with pytest.raises(NotImplementedError, match="trial axis.*9b"):
        orch.run(_spec(katib_tpu_torch, lambda ctx: None, name="wb"))


def test_mesh_devices_may_repeat_a_card_and_default_gpus_must_suffice(monkeypatch, tmp_path):
    """A config mesh spans the first prod(axes) visible GPUs (here a
    stand-in list that repeats one device, as an explicit grid may), a CPU
    orchestrator CPU entries; with too few GPUs it raises."""
    import katib_tpu_torch
    import katib_tpu_torch.core.types  # noqa: F401
    from katib_tpu_torch.core.config import KatibConfig
    from katib_tpu_torch.orchestrator.orchestrator import Orchestrator

    config = KatibConfig.from_dict({"init": {"mesh_axes": {"data": 2}}})
    spec = config.apply_to(_spec(katib_tpu_torch, lambda ctx: None))
    orch = Orchestrator(config=config, device="cpu", workdir=str(tmp_path))
    mesh = orch._resolve_mesh(spec)
    assert dict(mesh.shape) == {"data": 2} and mesh.route == "shared device"
    orch.device = torch.device("cuda")  # a GPU orchestrator takes the visible GPUs
    monkeypatch.setattr(tmesh, "visible_gpus", lambda: _cpu(3))
    mesh = orch._resolve_mesh(spec)
    assert dict(mesh.shape) == {"data": 2} and mesh.entries == (torch.device("cpu"),) * 2
    monkeypatch.setattr(tmesh, "visible_gpus", lambda: _cpu(1))
    with pytest.raises(RuntimeError, match="asks for 2 GPUs and 1 are visible"):
        orch._resolve_mesh(spec)
