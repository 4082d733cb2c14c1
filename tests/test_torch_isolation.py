"""The port stands alone: no JAX, no module of the JAX package, and a run
meant for the card never carries on on the CPU."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from katib_tpu_torch.device import resolve_device

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "katib_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "katib_tpu")


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def _banned(name: str) -> bool:
    # exact names: katib_tpu_torch starts with "katib_tpu" but is not it
    return any(name == b or name.startswith(b + ".") for b in BANNED)


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_katib_tpu_imports(path):
    bad = sorted(n for n in _imported_modules(path) if _banned(n))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_banned_check_compares_module_names_exactly():
    assert _banned("katib_tpu") and _banned("katib_tpu.ops") and _banned("jax.numpy")
    assert not _banned("katib_tpu_torch") and not _banned("katib_tpu_torch.ops")
    assert not _banned("jaxtyping")


def test_port_imports_and_steps_with_jax_and_katib_tpu_blocked():
    """Every module imports, and one DARTS search step, a short transformer
    trial, the shipped DARTS spec through the port's loader and orchestrator
    under the async engine (one tiny epoch), one ``mnist_trial`` epoch, one
    round of the Hyperband sweep's suggestions, and one round of the shipped
    ENAS spec's suggestions with one tiny child epoch run, a black-box
    trial, a TFEvent file written and read, the Sobol, CMA-ES and random
    suggesters of the shipped command specs, one PBT toy trial of
    ``simple-pbt.yaml``, a two-member ``mnist_trial`` cohort, and the
    shipped ``pbt-ondevice.yaml``'s population evolved for two short
    generations on synthetic digits, with JAX and the JAX package
    unimportable."""
    script = textwrap.dedent(f"""
        import sys
        for name in {BANNED!r}:
            sys.modules[name] = None
        import importlib, math, os, pkgutil
        import katib_tpu_torch
        for mod in pkgutil.walk_packages(katib_tpu_torch.__path__, "katib_tpu_torch."):
            importlib.import_module(mod.name)
        import torch
        from katib_tpu_torch.nas.darts.architect import DartsHyper, init_search_state, make_search_step
        from katib_tpu_torch.nas.darts.model import DartsNetwork, init_alphas
        from katib_tpu_torch.parallel.train import cross_entropy_loss
        net = DartsNetwork(primitives=("skip_connection", "max_pooling_3x3"), init_channels=2,
                           num_layers=3, n_nodes=1, num_classes=3, dtype=torch.float32)
        gen = torch.Generator().manual_seed(0)
        net.reset_parameters(gen)
        loss = lambda w, a, b: cross_entropy_loss(torch.func.functional_call(net, w, (b[0], a)), b[1])
        hyper = DartsHyper(total_steps=1)
        state = init_search_state(dict(net.named_parameters()), init_alphas(1, 2, gen), hyper)
        batch = (torch.randn(2, 8, 8, 3, generator=gen), torch.tensor([0, 2]))
        state, metrics = make_search_step(loss, hyper)(state, batch, batch)
        assert state.step == 1 and bool(torch.isfinite(metrics["train_loss"]))
        # the transformer trial: two steps, the fewest its warmup-cosine
        # schedule takes (one warmup step, one decay step, as in optax)
        from katib_tpu_torch.models import transformer_trial
        from katib_tpu_torch.runner.context import TrialContext
        ctx = TrialContext({{"vocab_size": "16", "d_model": "16", "n_heads": "2", "n_layers": "1",
                            "seq_len": "8", "n_seq": "16", "batch_size": "2", "steps": "2"}},
                           device="cpu")
        transformer_trial(ctx)
        assert len(ctx.reports) == 2 and all(
            math.isfinite(v) for _, m in ctx.reports for v in m.values()), ctx.reports
        # the shipped DARTS spec through the port's loader and orchestrator,
        # cut to one tiny epoch through its own algorithm settings
        import tempfile, yaml
        from katib_tpu_torch.core.types import TrialCondition
        from katib_tpu_torch.orchestrator import Orchestrator
        from katib_tpu_torch.sdk.yaml_spec import experiment_spec_from_dict
        with open("examples/nas/darts.yaml") as f:
            doc = yaml.safe_load(f)
        tiny = {{"num_epochs": "1", "n_train": "16", "n_test": "8", "init_channels": "2"}}
        doc["spec"]["algorithm"]["algorithmSettings"] = [
            s for s in doc["spec"]["algorithm"]["algorithmSettings"] if s["name"] not in tiny
        ] + [{{"name": k, "value": v}} for k, v in tiny.items()]
        spec = experiment_spec_from_dict(doc)
        assert spec.train_fn.__module__ == "katib_tpu_torch.nas.darts.search", spec.train_fn
        orch = Orchestrator(workdir=tempfile.mkdtemp(), device="cpu")
        exp = orch.run(spec)
        (trial,) = exp.trials.values()
        assert trial.condition is TrialCondition.SUCCEEDED, (trial.condition, trial.message)
        assert exp.optimal is not None and exp.optimal.trial_name == trial.name
        # ... under the async engine, its supervisor, and the soak's modules
        assert orch.async_stats is not None and orch.async_stats["fallback"] is None
        for name in ("async_loops", "supervisor", "soak"):
            assert "katib_tpu_torch.orchestrator." + name in sys.modules, name
        # one mnist_trial epoch, and one round of the Hyperband sweep's suggester
        from katib_tpu_torch.models.mnist import mnist_trial
        from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml
        from katib_tpu_torch.suggest.base import make_suggester
        from katib_tpu_torch.core.types import Experiment
        ctx = TrialContext({{"arch": "cnn", "channels": "2", "n_train": "64", "n_test": "16",
                            "epochs": "1", "batch_size": "32"}}, device="cpu")
        mnist_trial(ctx)
        assert [s for s, _ in ctx.reports] == [0], ctx.reports
        spec = load_experiment_yaml("katib_tpu_torch/specs/hyperband-mnist.yaml")
        assert spec.train_fn is mnist_trial
        props = make_suggester(spec).get_suggestions(Experiment(spec=spec), 16)
        assert len(props) == 16 and {{p.labels["hyperband-s"] for p in props}} == {{"2"}}
        # the shipped ENAS spec: one round of its suggester, one tiny child epoch
        from katib_tpu_torch.nas.enas.trial import enas_trial
        spec = load_experiment_yaml("examples/nas/enas.yaml")
        assert spec.train_fn is enas_trial
        props = make_suggester(spec, device="cpu").get_suggestions(Experiment(spec=spec), 4)
        assert [p.labels["enas-round"] for p in props] == ["0"] * 4
        ctx = TrialContext(dict(props[0].as_dict(), n_train="32", n_test="8", channels="2",
                                num_epochs="1", batch_size="16"), device="cpu")
        enas_trial(ctx)
        assert [s for s, _ in ctx.reports] == [0], ctx.reports
        # a black-box trial (stdout and TFEvent collectors), the host
        # suggesters of the command specs, and the PBT toy trial
        from katib_tpu_torch.core import types as T
        from katib_tpu_torch.runner.tfevent import TFEventWriter, parse_tfevent_dir
        from katib_tpu_torch.runner.trial_runner import run_trial
        from katib_tpu_torch.store.base import MemoryObservationStore
        obj = T.ObjectiveSpec(type=T.ObjectiveType.MINIMIZE, objective_metric_name="loss")
        store = MemoryObservationStore()
        trial = T.Trial(name="bb", spec=T.TrialSpec(
            command=[sys.executable, "-c", "print('loss=0.5')"], assignments=[]))
        assert run_trial(trial, store, obj).condition is T.TrialCondition.SUCCEEDED
        assert [l.value for l in store.get("bb", "loss")] == [0.5]
        logdir = tempfile.mkdtemp()
        w = TFEventWriter(logdir)
        w.add_scalar("loss", 0.25, step=1, wall_time=1.0)
        w.close()
        assert [l.value for l in parse_tfevent_dir(logdir)] == [0.25]
        for name in ("sobol", "cmaes", "random"):
            spec = load_experiment_yaml(f"examples/hp-tuning/{{name.replace('cmaes', 'cma-es')}}.yaml")
            assert len(make_suggester(spec).get_suggestions(Experiment(spec=spec), 4)) == 4
        from katib_tpu_torch.models.pbt_toy import pbt_toy_trial
        spec = load_experiment_yaml("examples/hp-tuning/simple-pbt.yaml")
        assert spec.train_fn is pbt_toy_trial
        os.chdir(tempfile.mkdtemp())
        props = make_suggester(spec).get_suggestions(Experiment(spec=spec), 2)
        ctx = TrialContext(props[0].as_dict(), checkpoint_dir=tempfile.mkdtemp(), device="cpu")
        pbt_toy_trial(ctx)
        assert [s for s, _ in ctx.reports] == [0, 1, 2, 3], ctx.reports
        # a vectorized cohort of two mnist_trial members, and on-device PBT
        from katib_tpu_torch.runner.cohort import run_cohort
        from katib_tpu_torch.utils import observability as obs
        obj = T.ObjectiveSpec(type=T.ObjectiveType.MAXIMIZE, objective_metric_name="accuracy")
        members = [T.Trial(name=f"c{{i}}", spec=T.TrialSpec(train_fn=mnist_trial, assignments=[
            T.ParameterAssignment(k, v) for k, v in dict(units=4, num_layers=1, epochs=1,
            batch_size=32, n_train=64, n_test=16, lr=0.1 * (i + 1)).items()]))
            for i in range(2)]
        results = run_cohort(members, store, obj, device="cpu")
        assert all(r.condition is T.TrialCondition.SUCCEEDED for r in results.values())
        assert obs.cohort_fallbacks.get() == 0 and obs.cohorts_executed.get() == 1
        from katib_tpu_torch.models import pbt_digits
        from katib_tpu_torch.models.data import synthetic_classification
        pbt_digits._DATASET_CACHE[(1400, 397)] = synthetic_classification(
            1400, 397, (8, 8, 1), 10)
        spec = load_experiment_yaml(os.path.join({str(ROOT)!r}, "examples", "hp-tuning",
                                                 "pbt-ondevice.yaml"))
        assert spec.train_fn is pbt_digits.pbt_digits_trial
        props = make_suggester(spec).get_suggestions(Experiment(spec=spec), 16)
        assert len(props) == 16 and props[0].labels[T.COHORT_KEY_LABEL] == "pbt-ondevice"
        members = [T.Trial(name=p.name, spec=T.TrialSpec(train_fn=spec.train_fn, assignments=[
            a for a in p.assignments if a.name not in ("pbt_generations",
            "pbt_steps_per_generation")] + [T.ParameterAssignment("pbt_generations", 2),
            T.ParameterAssignment("pbt_steps_per_generation", 3)], labels=dict(p.labels)),
            checkpoint_dir=tempfile.mkdtemp()) for p in props]
        results = run_cohort(members, store, spec.objective, device="cpu")
        assert all(r.condition is T.TrialCondition.SUCCEEDED for r in results.values())
        assert {{t.spec.labels["pbt-generation"] for t in members}} == {{"2"}}
        assert obs.cohort_fallbacks.get() == 0 and obs.pbt_generations.get() == 2
        leaked = sorted(n for n in sys.modules if n.split(".")[0] in {BANNED!r} and sys.modules[n])
        assert not leaked, leaked
        print("ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_mesh_path_runs_with_jax_and_katib_tpu_blocked():
    """The mesh path's modules (``parallel/{mesh,collectives,distributed,
    ring_attention}.py``, ``entry.py``) import, and one sharded DARTS step on
    a ``{data: 2, model: 2}`` grid of CPU entries and one ring-attention
    step (forward and backward) on ``{seq: 4}`` run, with JAX and the JAX
    package unimportable."""
    script = textwrap.dedent(f"""
        import sys
        for name in {BANNED!r}:
            sys.modules[name] = None
        import copy
        import torch
        import katib_tpu_torch.entry
        import katib_tpu_torch.parallel.distributed
        from katib_tpu_torch.nas.darts.architect import DartsHyper, init_search_state, make_search_step
        from katib_tpu_torch.nas.darts.model import DartsNetwork, init_alphas
        from katib_tpu_torch.ops.flash_attention import reference_attention
        from katib_tpu_torch.parallel.collectives import replica_index
        from katib_tpu_torch.parallel.mesh import make_mesh, shard_batch
        from katib_tpu_torch.parallel.ring_attention import make_sequence_parallel_attention
        from katib_tpu_torch.parallel.train import cross_entropy_loss
        mesh = make_mesh({{"data": 2, "model": 2}}, devices=["cpu"] * 4)
        net = DartsNetwork(primitives=("skip_connection", "separable_convolution_3x3"),
                           init_channels=2, num_layers=2, n_nodes=1, num_classes=3,
                           dtype=torch.float32, remat=False)
        gen = torch.Generator().manual_seed(0)
        net.reset_parameters(gen)
        nets = [net] + [copy.deepcopy(net) for _ in range(3)]
        loss = lambda w, a, b: cross_entropy_loss(
            torch.func.functional_call(nets[replica_index()], w, (b[0], a)), b[1])
        hyper = DartsHyper(total_steps=1)
        state = init_search_state(dict(net.named_parameters()), init_alphas(1, 2, gen), hyper)
        batch = shard_batch((torch.randn(4, 8, 8, 3, generator=gen), torch.tensor([0, 2, 1, 0])),
                            mesh)
        state, metrics = make_search_step(loss, hyper, mesh)(state, batch, batch)
        assert state.step == 1 and bool(torch.isfinite(metrics["train_loss"]))
        ring = make_sequence_parallel_attention(make_mesh({{"seq": 4}}, devices=["cpu"] * 4))
        q, k, v = (torch.randn(1, 2, 32, 8, generator=gen, requires_grad=True) for _ in range(3))
        out = ring(q, k, v)
        out.sum().backward()
        assert torch.allclose(out, reference_attention(q, k, v), atol=1e-5)
        assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
        leaked = sorted(n for n in sys.modules if n.split(".")[0] in {BANNED!r} and sys.modules[n])
        assert not leaked, leaked
        print("ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_suggestion_service_and_composer_child_run_with_jax_and_katib_tpu_blocked(tmp_path):
    """The suggestion service, ``remote`` against it (tpe, and the shipped
    ENAS spec's first round), and the composer's ``suggest-server`` child
    (``endpoint: auto``), with JAX and the JAX package unimportable in this
    process and, through a ``sitecustomize`` on ``PYTHONPATH``, in the
    child: a child that imported either would die before it is healthy."""
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(
        f"import sys\nfor name in {BANNED!r}:\n    sys.modules[name] = None\n")
    script = textwrap.dedent(f"""
        import sys
        for name in {BANNED!r}:
            assert sys.modules.get(name, 0) is None, name
        import tempfile
        from katib_tpu_torch.core import types as T
        from katib_tpu_torch.orchestrator import Orchestrator
        from katib_tpu_torch.sdk.yaml_spec import load_experiment_yaml
        from katib_tpu_torch.suggest.base import make_suggester
        from katib_tpu_torch.suggest.service import serve_suggestions
        svc = serve_suggestions(device="cpu", token="t0k")
        def spec(name, settings):
            return T.ExperimentSpec(
                name=name, algorithm=T.AlgorithmSpec(name="remote", settings=settings),
                objective=T.ObjectiveSpec(type=T.ObjectiveType.MAXIMIZE,
                                          objective_metric_name="accuracy"),
                parameters=[T.ParameterSpec("x", T.ParameterType.DOUBLE,
                                            T.FeasibleSpace(min=0.0, max=1.0))],
                max_trial_count=3, parallel_trial_count=1,
                train_fn=lambda ctx: ctx.report(step=0, accuracy=float(ctx.params["x"])))
        endpoint = f"http://127.0.0.1:{{svc.port}}"
        exp = Orchestrator(workdir=tempfile.mkdtemp(), device="cpu").run(
            spec("iso-tpe", {{"endpoint": endpoint, "algorithm": "tpe", "token": "t0k"}}))
        assert exp.succeeded_count == 3, exp.message
        enas = load_experiment_yaml("examples/nas/enas.yaml")
        enas.algorithm = T.AlgorithmSpec(name="remote", settings={{
            **enas.algorithm.settings, "endpoint": endpoint, "algorithm": "enas", "token": "t0k"}})
        props = make_suggester(enas).get_suggestions(T.Experiment(spec=enas), 4)
        assert [p.labels["enas-round"] for p in props] == ["0"] * 4
        svc.stop()
        exp = Orchestrator(workdir=tempfile.mkdtemp(), device="cpu").run(
            spec("iso-auto", {{"endpoint": "auto", "algorithm": "random"}}))
        assert exp.succeeded_count == 3, exp.message
        leaked = sorted(n for n in sys.modules if n.split(".")[0] in {BANNED!r} and sys.modules[n])
        assert not leaked, leaked
        print("ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": f"{blocker}{os.pathsep}{ROOT}", "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_native_runtime_and_db_manager_child_run_with_jax_and_katib_tpu_blocked(tmp_path):
    """The native runtime built from a tree that holds ``katib_tpu_torch``
    and nothing of the JAX package (so its build reads no file under
    ``katib_tpu/``), every compiler argument inside that tree; then the
    native store, the C++ parser behind ``parse_text_lines_fast``, a loader
    epoch, and a ``db-manager`` child (JAX and the JAX package blocked in it
    through a ``sitecustomize``) serving a remote store, with JAX and the
    JAX package unimportable in this process too."""
    import shutil

    tree = tmp_path / "tree"
    shutil.copytree(PACKAGE, tree / "katib_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(
        f"import sys\nfor name in {BANNED!r}:\n    sys.modules[name] = None\n")
    script = textwrap.dedent(f"""
        import sys
        for name in {BANNED!r}:
            assert sys.modules.get(name, 0) is None, name
        import os, subprocess, tempfile
        import numpy as np
        argvs = []
        real_popen = subprocess.Popen
        def recording(cmd, *a, **k):
            argvs.append(list(map(str, cmd)))
            return real_popen(cmd, *a, **k)
        subprocess.Popen = recording
        from katib_tpu_torch.native import build
        assert not build.BUILD_DIR.exists(), build.BUILD_DIR
        assert build.build() == {{"libkatibnative.so": True, "katib-db-manager": True}}
        compiles = [a for a in argvs if a[0].endswith("g++")]
        assert len(compiles) == 2, argvs
        for arg in (x for a in compiles for x in a[1:]):
            assert not arg.startswith("/") or arg.startswith({str(tree)!r}), arg
        from katib_tpu_torch.native import NativeBatchLoader, NativeObservationStore
        from katib_tpu_torch.runner.metrics import parse_text_lines_fast, text_parser
        store = NativeObservationStore()
        store.report_point("t", "loss", 0.5)
        assert [m.value for m in store.get("t")] == [0.5]
        assert text_parser() == "native"
        assert [m.value for m in parse_text_lines_fast(["loss=0.25"], ["loss"])] == [0.25]
        x = np.arange(48, dtype=np.float32).reshape(12, 2, 2)
        with NativeBatchLoader(x, np.arange(12, dtype=np.int32), batch=4, seed=1,
                               cache_path=os.path.join(tempfile.mkdtemp(), "d.bin")) as dl:
            assert sorted(int(v) for _, y in dl.epoch() for v in y) == list(range(12))
        child = real_popen([sys.executable, "-m", "katib_tpu_torch", "db-manager", "--port", "0"],
                           stdout=subprocess.PIPE, text=True)
        line = child.stdout.readline()
        assert line.startswith("katib-tpu db-manager: 127.0.0.1:"), line
        from katib_tpu_torch.core.config import KatibConfig
        remote = KatibConfig.from_dict({{"store": {{"backend": "remote", "host": "127.0.0.1",
            "port": int(line.split()[2].split(":")[1])}}}}).store.make_store()
        remote.report_point("t", "acc", 0.75, step=2)
        assert [(m.value, m.step) for m in remote.get("t", "acc")] == [(0.75, 2)]
        remote.close()
        child.terminate()
        assert child.wait(timeout=30) == 0
        leaked = sorted(n for n in sys.modules if n.split(".")[0] in {BANNED!r} and sys.modules[n])
        assert not leaked, leaked
        print("ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=tree, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": f"{blocker}{os.pathsep}{tree}", "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_cuda_is_refused_where_there_is_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            resolve_device(asked)
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
