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
