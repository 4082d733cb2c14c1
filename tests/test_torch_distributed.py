"""The port's process-group glue and slice allocator against the JAX
package's (the cases of ``tests/test_distributed.py``).

The JAX allocator leases the conftest's 8 virtual CPU devices; the port's
leases positions of a list of 8 CPU entries, so its shares are disjoint by
position.  Concurrent trials of the port's orchestrator each get a leased
sub-mesh, as the JAX package's do.
"""

from __future__ import annotations

import threading

import jax
import pytest

from katib_tpu.parallel import distributed as jdist
from katib_tpu_torch.parallel import distributed as tdist
from katib_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

CPU8 = ["cpu"] * 8


class TestInitializeDistributed:
    def test_single_process_is_noop(self, monkeypatch):
        monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
        monkeypatch.delenv("NUM_PROCESSES", raising=False)
        assert tdist.initialize_distributed() is jdist.initialize_distributed() is False
        monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
        monkeypatch.setenv("NUM_PROCESSES", "1")
        assert tdist.initialize_distributed() is False

    def test_multi_host_raises_naming_the_roadmap_item(self, monkeypatch):
        monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
        monkeypatch.setenv("NUM_PROCESSES", "2")
        with pytest.raises(NotImplementedError, match="multi-host.*9b"):
            tdist.initialize_distributed()

    def test_topology_sizes(self):
        for name in ("v5e-1", "v5e-8", "v5e-64", "v5e-256"):
            assert tdist.topology_size(name) == jdist.topology_size(name)
        for mod in (tdist, jdist):
            with pytest.raises(ValueError):
                mod.topology_size("v6e-9000")


class TestSliceAllocator:
    def test_partitions_devices_disjointly(self):
        want = jdist.SliceAllocator(2, devices=jax.devices())
        alloc = tdist.SliceAllocator(2, devices=CPU8)
        assert alloc.n_slices == want.n_slices == 4
        leases = [alloc.lease(timeout=1) for _ in range(4)]
        jleases = [want.lease(timeout=1) for _ in range(4)]
        seen = set()
        for lease, jlease in zip(leases, jleases):
            assert len(lease.devices) == len(jlease.devices) == 2
            assert lease.index == jlease.index
            assert not seen & set(lease.positions)
            seen.update(lease.positions)
        assert alloc.available() == want.available() == 0
        for lease in leases:
            alloc.release(lease)
        assert alloc.available() == 4

    def test_lease_blocks_until_release(self):
        alloc = tdist.SliceAllocator(4, devices=CPU8)  # 2 slices
        a = alloc.lease(timeout=1)
        b = alloc.lease(timeout=1)
        got = []

        def taker():
            got.append(alloc.lease(timeout=5))

        t = threading.Thread(target=taker)
        t.start()
        alloc.release(a)
        t.join(timeout=5)
        assert got and got[0].index == a.index
        alloc.release(b)
        alloc.release(got[0])

    def test_lease_timeout(self):
        alloc = tdist.SliceAllocator(8, devices=CPU8)  # 1 slice
        lease = alloc.lease(timeout=1)
        with pytest.raises(TimeoutError):
            alloc.lease(timeout=0.05)
        alloc.release(lease)

    def test_double_release_rejected(self):
        alloc = tdist.SliceAllocator(4, devices=CPU8)
        lease = alloc.lease(timeout=1)
        alloc.release(lease)
        with pytest.raises(ValueError):
            alloc.release(lease)

    def test_mesh_axes_template(self):
        alloc = tdist.SliceAllocator(4, devices=CPU8, axes={DATA_AXIS: -1, MODEL_AXIS: 2})
        jalloc = jdist.SliceAllocator(4, devices=jax.devices(),
                                      axes={DATA_AXIS: -1, MODEL_AXIS: 2})
        with alloc.slice_mesh(timeout=1) as mesh, jalloc.slice_mesh(timeout=1) as jmesh:
            assert dict(mesh.shape) == dict(jmesh.shape) == {DATA_AXIS: 2, MODEL_AXIS: 2}

    def test_defaults_to_the_visible_gpus_or_raises(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tdist.SliceAllocator(1)
        with pytest.raises(ValueError):
            tdist.SliceAllocator(0, devices=CPU8)
        with pytest.raises(ValueError):
            tdist.SliceAllocator(9, devices=CPU8)


class TestOrchestratorSliceScheduling:
    def _spec(self, package, trainer):
        types = package.core.types
        return types.ExperimentSpec(
            name="slice-sched",
            algorithm=types.AlgorithmSpec(name="random"),
            objective=types.ObjectiveSpec(type=types.ObjectiveType.MAXIMIZE,
                                          objective_metric_name="accuracy"),
            parameters=[types.ParameterSpec("x", types.ParameterType.DOUBLE,
                                            types.FeasibleSpace(min=0.0, max=1.0))],
            max_trial_count=6,
            parallel_trial_count=3,
            train_fn=trainer,
        )

    def test_parallel_trials_get_disjoint_meshes(self):
        import katib_tpu
        import katib_tpu.core.types  # noqa: F401
        import katib_tpu_torch
        import katib_tpu_torch.core.types  # noqa: F401
        from katib_tpu.orchestrator import Orchestrator as JOrchestrator
        from katib_tpu_torch.orchestrator.orchestrator import Orchestrator

        results = {}
        for name, package, orch_cls, alloc in (
            ("jax", katib_tpu, JOrchestrator, jdist.SliceAllocator(2, devices=jax.devices())),
            ("port", katib_tpu_torch, Orchestrator, tdist.SliceAllocator(2, devices=CPU8)),
        ):
            seen, live, overlaps = [], set(), []
            lock = threading.Lock()
            lease, release = alloc.lease, alloc.release

            def held(got):  # the port's shares by position, the JAX ones by device
                return set(getattr(got, "positions", None) or got.devices)

            def leasing(*a, _lease=lease, _live=live, _overlaps=overlaps, **k):
                got = _lease(*a, **k)
                with lock:
                    _overlaps.append(bool(_live & held(got)))
                    _live.update(held(got))
                return got

            def releasing(got, _release=release, _live=live):
                with lock:
                    _live.difference_update(held(got))
                _release(got)

            alloc.lease, alloc.release = leasing, releasing

            def trainer(ctx, _seen=seen):
                with lock:
                    _seen.append(tuple(ctx.mesh.devices.flat))
                ctx.report(accuracy=float(ctx.params["x"]), step=0)

            kwargs = {"device": "cpu"} if name == "port" else {}
            exp = orch_cls(slice_allocator=alloc, **kwargs).run(
                self._spec(package, trainer))
            results[name] = (exp.condition.value, len(seen),
                             sorted({len(d) for d in seen}), any(overlaps))
            assert alloc.available() == alloc.n_slices
        assert results["port"] == results["jax"] == ("MaxTrialsReached", 6, [2], False)


def test_the_elastic_allocator_raises_naming_9b():
    assert hasattr(jdist, "ElasticSliceAllocator")
    with pytest.raises(NotImplementedError, match="9b"):
        tdist.ElasticSliceAllocator(devices=CPU8)
