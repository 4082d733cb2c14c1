"""The DARTS search trial of the port as a whole, against the JAX package's.

The epoch loop runs in float32 from the same initial state on both sides:
the JAX ``run_darts_search`` runs as it is (second order), its network
built in float32 and its initial weights, per-step metrics and final state
recorded through the module names it calls; the port's ``search_epochs``
then starts from those weights.  The batches are the same numpy permutation
draws on both sides.  (The raw alpha gradient is compared in
``test_torch_architect.py``.)  Then ``darts_trial`` runs through the port's
``TrialContext``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import katib_tpu.costmodel
import katib_tpu.nas.darts.search as jsearch
from katib_tpu.core.types import Experiment
from katib_tpu.models import data as jdata
from katib_tpu.nas.darts import service as jservice
from katib_tpu.nas.darts.model import DartsNetwork as JNet
from katib_tpu.parallel.train import cross_entropy_loss as j_cross_entropy
from katib_tpu.sdk.yaml_spec import load_experiment_yaml
from katib_tpu_torch.convert import alphas_from_jax, state_dict_from_flax
from katib_tpu_torch.models import data as tdata
from katib_tpu_torch.nas.darts import service as tservice
from katib_tpu_torch.nas.darts.architect import DartsHyper, init_search_state
from katib_tpu_torch.nas.darts.model import DartsNetwork, extract_genotype
from katib_tpu_torch.nas.darts.ops import DEFAULT_PRIMITIVES
from katib_tpu_torch.nas.darts.search import darts_trial, search_epochs
from katib_tpu_torch.runner.context import TrialContext

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

PRIMS = ("separable_convolution_3x3", "max_pooling_3x3", "skip_connection")
NET = dict(num_layers=3, init_channels=4, n_nodes=2)
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "nas", "darts.yaml")


def _dataset(package):
    # 16 train images -> 8 per half -> 2 steps of 4; 8 test images
    return package.synthetic_classification(16, 8, (8, 8, 3), 4, seed=7)


def test_data_copy_makes_the_same_datasets():
    for name in ("cifar10", "mnist"):
        want = jdata.load_named_dataset(name, 32, 16)
        got = tdata.load_named_dataset(name, 32, 16)
        assert got.num_classes == want.num_classes and got.input_shape == want.input_shape
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="unknown dataset"):
        tdata.load_named_dataset("imagenet")


class _F32Net(JNet):
    """The JAX supernet in float32, its init jitted (eager init is ~3x slower)."""

    dtype: Any = jnp.float32

    def init(self, rngs, *args, **kwargs):
        return jax.jit(functools.partial(JNet.init, self, **kwargs))(rngs, *args)


@pytest.fixture(scope="module")
def jax_run():
    """One JAX search epoch in float32, with what the port needs recorded."""
    rec = {"steps": []}
    mp = pytest.MonkeyPatch()
    mp.setattr(jsearch, "DartsNetwork", _F32Net)

    def init_state(weights, alphas, hyper):
        rec["weights"], rec["alphas"] = jax.device_get((weights, alphas))
        return real_init(weights, alphas, hyper)

    def make_step(loss_fn, hyper, mesh=None, jit=True):
        rec["hyper"] = hyper
        step = real_make(loss_fn, hyper, mesh, jit)

        def recording(state, train, val):
            state, metrics = step(state, train, val)
            rec["steps"].append(jax.device_get(metrics))
            rec["state"] = state
            return state, metrics

        return recording

    real_init, real_make = jsearch.init_search_state, jsearch.make_search_step
    mp.setattr(jsearch, "init_search_state", init_state)
    mp.setattr(jsearch, "make_search_step", make_step)
    # the cost-model trace would re-trace the recording step: telemetry only
    mp.setattr(katib_tpu.costmodel, "observe_program", lambda *a, **k: None)
    reports = []
    try:
        result = jsearch.run_darts_search(
            _dataset(jdata), primitives=PRIMS, **NET, num_epochs=1, batch_size=4, seed=3,
            remat=False, step_loop=False,
            report=lambda **kw: reports.append(kw) or True,
        )
    finally:
        mp.undo()
    net = JNet(primitives=PRIMS, **NET, num_classes=4, remat=False, dtype=jnp.float32)
    ds = _dataset(jdata)
    state = rec["state"]
    logits = jax.jit(net.apply)(state.weights, jnp.asarray(ds.x_test), state.alphas)
    rec["eval_loss"] = float(j_cross_entropy(logits, jnp.asarray(ds.y_test)))
    rec.update(result=result, reports=reports)
    return rec


def test_epoch_loop_matches_jax(jax_run):
    net = DartsNetwork(primitives=PRIMS, **NET, num_classes=4, remat=False, dtype=torch.float32)
    hyper = DartsHyper(**jax_run["hyper"]._asdict())
    state = init_search_state(
        state_dict_from_flax(jax_run["weights"], net), alphas_from_jax(jax_run["alphas"]), hyper
    )
    reports = []
    state, history = search_epochs(
        net, state, _dataset(tdata), hyper=hyper, num_epochs=1, batch_size=4, seed=3,
        device=torch.device("cpu"), report=lambda **kw: reports.append(kw) or True,
    )
    (row,) = history
    assert len(row["steps"]) == len(jax_run["steps"]) == 2
    for i, (got, want) in enumerate(zip(row["steps"], jax_run["steps"])):
        for name in ("train_loss", "val_loss", "grad_norm", "w_lr"):
            assert got[name] == pytest.approx(float(want[name]), rel=1e-4), (i, name)
    (want,) = jax_run["reports"]
    (got,) = reports
    assert got["epoch"] == want["epoch"] == 0
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert row["val_accuracy"] == jax_run["result"]["history"][0]["val_accuracy"]
    assert row["val_loss"] == pytest.approx(jax_run["eval_loss"], rel=1e-4)
    genotype = extract_genotype(state.alphas, PRIMS, n_nodes=NET["n_nodes"])
    assert genotype == jax_run["result"]["genotype"]


def _ctx(tmp_path, settings, device="cpu", **kw):
    params = {
        "algorithm-settings": json.dumps(settings),
        "search-space": json.dumps(list(PRIMS)),
        "num-layers": "3",
    }
    return TrialContext(params, checkpoint_dir=str(tmp_path / "trial"), device=device, **kw)


SMALL = {"batch_size": 4, "init_channels": 4, "num_nodes": 2, "num_epochs": 2,
         "n_train": 16, "n_test": 8, "remat": "false", "unrolled": "false"}


def test_darts_trial_reports_and_writes_genotype(tmp_path):
    ctx = _ctx(tmp_path, {**SMALL, "remat": "true"}, step_times=[])
    darts_trial(ctx)
    assert [step for step, _ in ctx.reports] == [0, 1]
    for _, metrics in ctx.reports:
        assert set(metrics) == {"accuracy", "loss"}
        assert 0.0 <= metrics["accuracy"] <= 1.0 and np.isfinite(metrics["loss"])
    assert len(ctx.step_times) == 4  # 2 epochs x 2 steps
    with open(tmp_path / "trial" / "genotype.json") as f:
        genotype = json.load(f)
    assert len(genotype["normal"]) == len(genotype["reduce"]) == 2
    assert genotype["best_accuracy"] == max(m["accuracy"] for _, m in ctx.reports)
    for op, edge in genotype["normal"][0] + genotype["reduce"][1]:
        assert op in PRIMS and 0 <= edge < 3


def test_darts_trial_stops_when_report_says_so(tmp_path):
    ctx = _ctx(tmp_path, SMALL)
    ctx.request_stop()
    darts_trial(ctx)
    assert [step for step, _ in ctx.reports] == [0]


@pytest.mark.parametrize("setting", [{"fused": "true"}])
def test_unported_settings_raise(tmp_path, setting):
    """Ported since the fused plan landed: ``fused`` runs the trial on the
    fused mixed ops (all 8 primitives, so the four conv primitives fuse),
    and its snapshot records the plan."""
    params = {"algorithm-settings": json.dumps({**SMALL, **setting}),
              "search-space": json.dumps(list(DEFAULT_PRIMITIVES)), "num-layers": "3"}
    ctx = TrialContext(params, checkpoint_dir=str(tmp_path / "trial"), device="cpu")
    darts_trial(ctx)
    assert [step for step, _ in ctx.reports] == [0, 1]
    assert all(np.isfinite(m["loss"]) for _, m in ctx.reports)
    with open(tmp_path / "trial" / "search" / "search_meta.json") as f:
        assert json.load(f)["fused"] is True


def test_trial_mesh_raises(tmp_path):
    """A trial mesh runs the sharded search (``test_torch_sharded_search.py``
    holds it to the JAX package's); only what the mesh path lacks raises."""
    from katib_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 2}, devices=["cpu"] * 2)
    ctx = _ctx(tmp_path, SMALL, mesh=mesh)
    darts_trial(ctx)
    assert [step for step, _ in ctx.reports] == [0, 1]
    assert all(np.isfinite(m["loss"]) for _, m in ctx.reports)
    with pytest.raises(NotImplementedError, match="9b"):
        darts_trial(_ctx(tmp_path / "loop", {**SMALL, "step_loop": "true"}, mesh=mesh))


@pytest.mark.parametrize("spec", ["darts.yaml", "darts-paper-protocol.yaml"])
def test_shipped_specs_run_on_the_cpu(tmp_path, spec):
    """Every setting of the shipped DARTS specs is accepted; only the data
    and widths are cut to test size."""
    with open(os.path.join(os.path.dirname(EXAMPLE), spec)) as f:
        raw = yaml.safe_load(f)["spec"]
    settings = {s["name"]: s["value"] for s in raw["algorithm"]["algorithmSettings"]}
    params = tservice.trial_parameters(
        raw["nasConfig"]["operations"], raw["nasConfig"]["graphConfig"]["numLayers"], settings
    )
    assigned = json.loads(params["algorithm-settings"])
    assigned.update(n_train=16, n_test=8, batch_size=4, init_channels=4, num_nodes=2)
    params["algorithm-settings"] = json.dumps(assigned)
    ctx = TrialContext(params, checkpoint_dir=str(tmp_path / "trial"), device="cpu")
    darts_trial(ctx)
    epochs = int(assigned["num_epochs"])
    augment = int(assigned.get("augment_epochs", 0))
    assert [step for step, _ in ctx.reports] == list(range(epochs)) + (
        [epochs + augment] if augment else [])
    assert os.path.isfile(tmp_path / "trial" / "search" / "search_meta.json")


def test_trial_resumes_from_its_checkpoint_dir(tmp_path):
    class StopAfterFirst(TrialContext):
        def report(self, step=None, **metrics):
            return super().report(step, **metrics) and step != 0

    first = StopAfterFirst(_ctx(tmp_path, SMALL).params, checkpoint_dir=str(tmp_path / "trial"),
                           device="cpu")
    darts_trial(first)
    second = _ctx(tmp_path, SMALL)
    darts_trial(second)
    assert [step for step, _ in first.reports] == [0]
    assert [step for step, _ in second.reports] == [1]
    full = _ctx(tmp_path / "full", SMALL)
    darts_trial(full)
    assert second.reports[0] == full.reports[1]
    with open(tmp_path / "trial" / "genotype.json") as a, open(
            tmp_path / "full" / "trial" / "genotype.json") as b:
        assert json.load(a) == json.load(b)


def test_trial_needs_a_gpu_unless_it_names_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        darts_trial(_ctx(tmp_path, SMALL, device=None))


def test_service_emits_the_jax_suggesters_parameters():
    spec = load_experiment_yaml(EXAMPLE)
    (want,) = jservice.DartsSuggester(spec).get_suggestions(Experiment(spec=spec), 1)
    with open(EXAMPLE) as f:
        raw = yaml.safe_load(f)["spec"]
    settings = {s["name"]: s["value"] for s in raw["algorithm"]["algorithmSettings"]}
    got = tservice.trial_parameters(
        raw["nasConfig"]["operations"], raw["nasConfig"]["graphConfig"]["numLayers"], settings
    )
    assert got == want.as_dict()


def test_default_settings_match_jax():
    assert tservice.DEFAULT_SETTINGS == jservice.DEFAULT_SETTINGS
    assert list(tservice.DEFAULT_SETTINGS) == list(jservice.DEFAULT_SETTINGS)


@pytest.mark.parametrize("settings,match", [
    ({"num_epochs": "-3"}, "num_epochs"), ({"w_lr": "abc"}, "w_lr"),
    ({"augment_epochs": "-1"}, "augment_epochs"), ({"dataset": "imagenet"}, "dataset"),
])
def test_settings_validation_rejects_what_jax_rejects(settings, match):
    spec = load_experiment_yaml(EXAMPLE)
    with pytest.raises(jservice.SuggesterError, match=match):
        jservice.DartsSuggester.validate(dataclasses.replace(
            spec, algorithm=dataclasses.replace(spec.algorithm, settings=settings)
        ))
    with pytest.raises(tservice.SuggesterError, match=match):
        tservice.validate_settings(settings)
