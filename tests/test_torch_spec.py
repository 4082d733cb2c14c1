"""The port's spec layer against the JAX package's: the YAML loader, the
validation errors, ``KatibConfig`` and the suggester registry.

Every YAML under ``examples/`` (the simulator scenarios aside) loads with
both loaders.  Where the JAX spec names a train function the port has, the
two ``ExperimentSpec``s agree field by field, the train function compared
by its dotted path after ``katib_tpu.`` maps to ``katib_tpu_torch.``; where
the port has none, its loader raises ``NotImplementedError`` naming it.
Nothing here compiles a JAX program."""

from __future__ import annotations

import copy
import dataclasses
import enum
import glob
import os

import pytest
import yaml

from katib_tpu.core.config import KatibConfig as JKatibConfig
from katib_tpu.core.validation import ValidationError as JValidationError
from katib_tpu.core.validation import validate_experiment as j_validate
from katib_tpu.sdk.yaml_spec import SpecError as JSpecError
from katib_tpu.sdk.yaml_spec import experiment_spec_from_dict as j_from_dict
from katib_tpu.sdk.yaml_spec import load_experiment_yaml as j_load
from katib_tpu_torch.core.config import ConfigError, KatibConfig
from katib_tpu_torch.core.types import AlgorithmSpec
from katib_tpu_torch.core.validation import ValidationError
from katib_tpu_torch.core.validation import validate_experiment
from katib_tpu_torch.sdk.yaml_spec import (
    SpecError,
    experiment_spec_from_dict,
    load_experiment_yaml,
    port_train_fn_path,
)
from katib_tpu_torch.store.base import MemoryObservationStore
from katib_tpu_torch.store.sqlite import SqliteObservationStore
from katib_tpu_torch.suggest import algorithms
from katib_tpu_torch.suggest.base import SuggesterError, make_suggester, registered_algorithms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(
    p
    for p in glob.glob(os.path.join(REPO, "examples", "**", "*.yaml"), recursive=True)
    if os.path.basename(os.path.dirname(p)) != "sim"
)
# the JAX train functions the port does not have yet (none since
# models/pbt_digits.py was ported)
UNPORTED_TRAIN_FNS: set[str] = set()


def _train_fn_path(raw: dict) -> str | None:
    spec = raw.get("spec", raw)
    return (spec.get("trialTemplate") or {}).get("trainFn") or spec.get("trainFn")


def normalized(value, port: bool):
    """A spec as plain data: dataclasses field by field, enums by value,
    functions by dotted path (a JAX path mapped into the port)."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: normalized(getattr(value, f.name), port)
                for f in dataclasses.fields(value)}
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, dict):
        return {k: normalized(v, port) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(normalized(v, port) for v in value)
    if callable(value):
        path = f"{value.__module__}.{value.__qualname__}"
        return path if port else port_train_fn_path(path)
    return value


@pytest.mark.parametrize("path", EXAMPLES, ids=[os.path.basename(p) for p in EXAMPLES])
def test_every_example_loads_as_in_the_jax_package(path):
    with open(path) as f:
        raw = yaml.safe_load(f)
    want = j_load(path)
    fn_path = _train_fn_path(raw)
    if fn_path in UNPORTED_TRAIN_FNS:
        with pytest.raises(NotImplementedError, match=fn_path.replace(".", r"\.")):
            load_experiment_yaml(path)
        return
    got = load_experiment_yaml(path)
    assert normalized(got, port=True) == normalized(want, port=False)
    validate_experiment(got)
    if fn_path is not None:
        assert got.train_fn.__module__.startswith("katib_tpu_torch.")


def test_enas_spec_resolves_to_the_ports_enas_trial():
    from katib_tpu_torch.nas.enas.trial import enas_trial

    spec = load_experiment_yaml(os.path.join(REPO, "examples", "nas", "enas.yaml"))
    assert spec.train_fn is enas_trial
    assert f"{enas_trial.__module__}.{enas_trial.__qualname__}" == (
        "katib_tpu_torch.nas.enas.trial.enas_trial")
    assert spec.algorithm.name == "enas" and spec.max_trial_count == 12
    assert spec.parallel_trial_count == 4


def test_train_fn_paths_map_into_the_port_and_leave_others_alone():
    assert port_train_fn_path("katib_tpu.nas.darts.search.darts_trial") == (
        "katib_tpu_torch.nas.darts.search.darts_trial")
    assert port_train_fn_path("mypkg.train.fn") == "mypkg.train.fn"
    assert port_train_fn_path("katib_tpu_torch.models.transformer.transformer_trial") == (
        "katib_tpu_torch.models.transformer.transformer_trial")


BASE = {
    "metadata": {"name": "x"},
    "spec": {
        "objective": {"type": "maximize", "objectiveMetricName": "accuracy"},
        "algorithm": {"algorithmName": "random"},
        "parameters": [{"name": "lr", "parameterType": "double",
                        "feasibleSpace": {"min": "0.01", "max": "0.1"}}],
        "trialTemplate": {"trainFn": "katib_tpu.nas.darts.search.darts_trial"},
    },
}

# (where, value) mutations of BASE that the loader or validation refuses
INVALID = {
    "no-name": (("metadata",), {}),
    "no-objective": (("spec", "objective"), None),
    "bad-objective-type": (("spec", "objective", "type"), "sideways"),
    "bad-resume-policy": (("spec", "resumePolicy"), "Sometimes"),
    "bad-parameter-type": (("spec", "parameters", 0, "parameterType"), "complex"),
    "inverted-range": (("spec", "parameters", 0, "feasibleSpace"), {"min": "1", "max": "0"}),
    "zero-parallel": (("spec", "parallelTrialCount"), 0),
    "train-fn-without-module": (("spec", "trialTemplate", "trainFn"), "darts_trial"),
    "missing-train-fn-module": (("spec", "trialTemplate", "trainFn"), "no_such_pkg.fn"),
}


def _mutated(where, value) -> dict:
    doc = copy.deepcopy(BASE)
    node = doc
    for key in where[:-1]:
        node = node[key]
    if value is None:
        node.pop(where[-1])
    else:
        node[where[-1]] = value
    return doc


def _outcome(load, validate, doc):
    try:
        validate(load(doc))
    except (JSpecError, SpecError, JValidationError, ValidationError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_specs_fail_with_the_jax_packages_errors(case):
    doc = _mutated(*INVALID[case])
    want = _outcome(j_from_dict, j_validate, copy.deepcopy(doc))
    assert want is not None, f"the JAX package accepts {case}"
    assert _outcome(experiment_spec_from_dict, validate_experiment, doc) == want


def test_config_builds_the_memory_and_sqlite_stores(tmp_path):
    assert isinstance(KatibConfig().store.make_store(), MemoryObservationStore)
    cfg = KatibConfig.from_dict({"store": {"backend": "sqlite", "path": str(tmp_path / "o.db")}})
    assert isinstance(cfg.store.make_store(), SqliteObservationStore)


@pytest.mark.parametrize("backend", ["native", "remote"])
def test_config_refuses_the_stores_the_port_lacks(backend):
    """Ported since the native runtime landed: ``native`` builds the C++
    store (or raises), ``remote`` a db-manager client of ``host:port``."""
    from katib_tpu_torch.native.dbmanager import RemoteObservationStore
    from katib_tpu_torch.native.store import NativeObservationStore

    cfg = KatibConfig.from_dict({"store": {"backend": backend, "host": "127.0.0.2",
                                           "port": 6790}})
    store = cfg.store.make_store()
    if backend == "native":
        assert isinstance(store, NativeObservationStore)
        store.report_point("t", "loss", 0.5)
        assert [m.value for m in store.get("t")] == [0.5]
    else:
        assert isinstance(store, RemoteObservationStore)
        assert (store.host, store.port) == ("127.0.0.2", 6790)


def test_config_loads_as_in_the_jax_package(tmp_path):
    doc = {"init": {"workdir": "w", "poll_interval": 0.5, "parallel_trial_count": 2},
           "runtime": {"algorithms": {"darts": {"settings": {"num_epochs": 3}}}},
           "store": {"backend": "sqlite"}}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(doc))
    env = {"KATIB_TPU_STORE_PATH": "obs.db"}
    assert normalized(KatibConfig.load(str(path), env=env), True) == normalized(
        JKatibConfig.load(str(path), env=env), False)
    for bad in ({"init": {"nope": 1}}, {"apiVersion": "v0"}, {"store": {"backend": "tape"}}):
        with pytest.raises(ConfigError):
            KatibConfig.from_dict(bad)


def test_config_refuses_mesh_axes():
    cfg = KatibConfig.from_dict({"init": {"mesh_axes": {"data": 2}}})
    with pytest.raises(NotImplementedError, match="mesh"):
        cfg.mesh_axes_for("darts")
    per_algo = KatibConfig.from_dict(
        {"runtime": {"algorithms": {"grid": {"mesh_axes": {"data": 4}}}}})
    assert per_algo.mesh_axes_for("random") == {}
    with pytest.raises(NotImplementedError, match="mesh"):
        per_algo.mesh_axes_for("grid")


def test_registry_holds_the_ported_suggesters():
    assert registered_algorithms() == ["asha", "bayesianoptimization", "cmaes", "darts",
                                       "enas", "grid", "hyperband", "multivariate-tpe", "pbt",
                                       "pbt-ondevice", "random", "remote", "sobol", "tpe"]


@pytest.mark.parametrize("name", ["remote"])
def test_unported_suggesters_raise_naming_their_jax_module(name):
    """The last unported algorithm, ``remote``, is ported: none raises
    ``NotImplementedError`` any more, and ``remote`` on a shipped spec
    refuses a missing endpoint as the JAX package's does."""
    from katib_tpu.suggest.base import SuggesterError as JSuggesterError
    from katib_tpu.suggest.base import make_suggester as j_make_suggester
    from katib_tpu.suggest.base import registered_algorithms as j_registered

    assert name in j_registered() and name in registered_algorithms()
    assert name not in algorithms.UNPORTED_ALGORITHMS
    path = os.path.join(REPO, "examples", "hp-tuning", "random.yaml")
    spec, j_spec = load_experiment_yaml(path), j_load(path)
    spec.algorithm = AlgorithmSpec(name=name)
    j_spec.algorithm = type(j_spec.algorithm)(name=name)
    with pytest.raises(JSuggesterError, match="endpoint") as want:
        j_make_suggester(j_spec)
    with pytest.raises(SuggesterError, match="endpoint") as got:
        make_suggester(spec)
    assert str(got.value) == str(want.value)


def test_the_port_and_the_jax_registry_cover_the_same_names():
    from katib_tpu.suggest.base import registered_algorithms as j_registered

    assert set(j_registered()) == set(registered_algorithms()) | set(
        algorithms.UNPORTED_ALGORITHMS)
