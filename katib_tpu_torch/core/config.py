"""Typed framework configuration — the KatibConfig equivalent (port of
``katib_tpu/core/config.py``: every store backend is built; ``native``
builds the C++ runtime or raises where the JAX package falls back to a
memory store; mesh axes resolve as in the JAX package, and the
orchestrator builds each trial's mesh from them).

The reference loads a single ``KatibConfig`` object (apiVersion
``config.kubeflow.org/v1beta1``) with an ``init`` section of controller flags
and a ``runtime`` registry mapping algorithm names to suggestion-service
images/resources (``pkg/apis/config/v1beta1/types.go:27-120``, loader
``pkg/util/v1beta1/katibconfig/config.go:60``, scheme defaulting
``defaults.go:76+``).  This config keeps the same two-section
shape but registers *in-process* runtime facts instead of container images:

- ``init``    — orchestrator flags (workdir, poll interval, default trial
  parallelism, profiler toggles) — the analog of ``ControllerConfig``.
- ``runtime`` — per-algorithm default settings and per-trial mesh shapes
  (the analog of per-algorithm image/resource registration), plus
  metrics-collector defaults per kind.
- ``store``   — observation-store backend selection (memory / sqlite /
  native / remote), the analog of the DB-manager connection config
  (``pkg/db/v1beta1/common/const.go`` env overrides).

Loading merges, in order: built-in defaults → YAML file → environment
variables (``KATIB_TPU_*``, the analog of ``consts/const.go:156-166``).
Unknown keys are rejected — parity with the reference's typed decode.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Mapping

import yaml

from katib_tpu_torch.core.types import ExperimentSpec


class ConfigError(ValueError):
    pass


def _check_keys(section: str, data: Mapping[str, Any], allowed: tuple[str, ...]) -> None:
    unknown = set(data) - set(allowed)
    if unknown:
        raise ConfigError(
            f"unknown {section} config keys: {sorted(unknown)} (allowed: {sorted(allowed)})"
        )


@dataclass
class InitConfig:
    """Orchestrator flags (reference ``ControllerConfig``, ``types.go:35-57``)."""

    workdir: str = "katib_runs"
    poll_interval: float = 0.02
    # default for ExperimentSpec.parallel_trial_count when unset (reference
    # default 3, ``experiment_defaults.go:35``)
    parallel_trial_count: int = 3
    # per-trial profiler traces under <workdir>/<exp>/<trial>/profile (the
    # port raises for it: katib_tpu/costmodel/profiler.py is not ported)
    # (the reference has no tracing at all — SURVEY.md §5 gap)
    enable_profiler: bool = False
    # default mesh axes for trial execution, e.g. {"data": 4, "model": 2};
    # empty = single-device / caller-provided mesh
    mesh_axes: dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "InitConfig":
        _check_keys("init", data, tuple(f.name for f in dataclasses.fields(cls)))
        return cls(**data)


@dataclass
class AlgorithmRuntimeConfig:
    """Per-algorithm registration (the analog of the reference's
    ``SuggestionConfig`` image/resources/PVC entry, ``types.go:77-96``)."""

    # defaults merged under the experiment's own algorithm settings
    settings: dict[str, str] = field(default_factory=dict)
    # mesh override for trials of this algorithm (DARTS wants the whole
    # slice; random-search trials can share chips)
    mesh_axes: dict[str, int] = field(default_factory=dict)
    # persistent state dir — the FromVolume-resume analog of the reference's
    # suggestion PVC (``composer.go:296``); suggester checkpoints live here
    persistent_dir: str | None = None

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "AlgorithmRuntimeConfig":
        _check_keys("runtime.algorithms", data, tuple(f.name for f in dataclasses.fields(cls)))
        out = cls(**data)
        out.settings = {k: str(v) for k, v in out.settings.items()}
        return out


@dataclass
class CollectorRuntimeConfig:
    """Per-kind metrics-collector defaults (reference
    ``MetricsCollectorConfig``, ``types.go:98-108``)."""

    filter: str | None = None
    path: str | None = None

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "CollectorRuntimeConfig":
        _check_keys("runtime.metrics_collectors", data, tuple(f.name for f in dataclasses.fields(cls)))
        return cls(**data)


@dataclass
class RuntimeConfig:
    algorithms: dict[str, AlgorithmRuntimeConfig] = field(default_factory=dict)
    early_stopping: dict[str, dict[str, str]] = field(default_factory=dict)
    metrics_collectors: dict[str, CollectorRuntimeConfig] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "RuntimeConfig":
        _check_keys("runtime", data, ("algorithms", "early_stopping", "metrics_collectors"))
        return cls(
            algorithms={
                name: AlgorithmRuntimeConfig.from_dict(v or {})
                for name, v in (data.get("algorithms") or {}).items()
            },
            early_stopping={
                name: {k: str(v) for k, v in (v or {}).items()}
                for name, v in (data.get("early_stopping") or {}).items()
            },
            metrics_collectors={
                kind: CollectorRuntimeConfig.from_dict(v or {})
                for kind, v in (data.get("metrics_collectors") or {}).items()
            },
        )


@dataclass
class StoreConfig:
    """Observation-store backend selection (the DB-manager connection analog)."""

    backend: str = "memory"  # memory | sqlite | native | remote | mysql | postgres
    path: str = "katib_observations.db"  # sqlite file
    host: str = "127.0.0.1"  # remote db-manager
    port: int = 6789
    # external-SQL backends (reference MySQL/Postgres DB-manager,
    # ``mysql/init.go:35``): ``user:password@host:port/dbname``
    dsn: str = ""

    _BACKENDS = ("memory", "sqlite", "native", "remote", "mysql", "postgres")

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "StoreConfig":
        _check_keys("store", data, ("backend", "path", "host", "port", "dsn"))
        out = cls(**data)
        if out.backend not in cls._BACKENDS:
            raise ConfigError(
                f"store.backend {out.backend!r} not in {cls._BACKENDS}"
            )
        return out

    def make_store(self):
        if self.backend == "memory":
            from katib_tpu_torch.store.base import MemoryObservationStore

            return MemoryObservationStore()
        if self.backend == "sqlite":
            from katib_tpu_torch.store.sqlite import SqliteObservationStore

            return SqliteObservationStore(self.path)
        if self.backend in ("mysql", "postgres"):
            return self._make_dbapi_store()
        if self.backend == "native":
            # builds the C++ runtime or raises: the JAX package returns a
            # memory store when it cannot build, the port never runs on a
            # store other than the one asked for
            from katib_tpu_torch.native.store import NativeObservationStore

            return NativeObservationStore()
        from katib_tpu_torch.native.dbmanager import RemoteObservationStore

        return RemoteObservationStore(self.host, self.port)

    def _make_dbapi_store(self):
        """External-SQL store over the reference's observation_logs schema
        (``store/dbapi.py``).  Drivers are imported lazily — whichever of
        the usual DB-API modules is installed is used."""
        from katib_tpu_torch.store.dbapi import DbapiObservationStore

        user, password, host, port, dbname = _parse_dsn(
            self.dsn, default_port=3306 if self.backend == "mysql" else 5432
        )
        candidates = (
            ("pymysql", "MySQLdb")
            if self.backend == "mysql"
            else ("psycopg2", "pg8000")
        )
        # database=, not dbname=: every candidate accepts database= (psycopg2
        # takes both spellings; pg8000's connect() only knows database=)
        kwargs = dict(
            user=user, password=password, host=host, port=port, database=dbname
        )
        import importlib

        last_err: Exception | None = None
        for mod_name in candidates:
            try:
                mod = importlib.import_module(mod_name)
            except ImportError as e:
                last_err = e
                continue
            return DbapiObservationStore(
                lambda: mod.connect(**kwargs), dialect=self.backend
            )
        raise ConfigError(
            f"store.backend {self.backend!r} needs one of {candidates} "
            f"installed (none importable: {last_err})"
        )


def _parse_dsn(
    dsn: str, default_port: int
) -> tuple[str, str, str, int, str]:
    """``user[:password]@host[:port]/dbname`` -> components (the shape of
    the reference's env-assembled MySQL DSN, ``mysql/mysql.go:40-55``)."""
    cred, _, rest = dsn.rpartition("@")
    user, _, password = cred.partition(":")
    hostport, _, dbname = rest.partition("/")
    host, _, port_s = hostport.partition(":")
    try:
        port = int(port_s) if port_s else default_port
    except ValueError:
        raise ConfigError(f"store.dsn has non-numeric port: {dsn!r}") from None
    if not host or not dbname:
        raise ConfigError(
            f"store.dsn must look like user:password@host:port/dbname, got {dsn!r}"
        )
    return user, password, host, port, dbname


# env-var overrides, the analog of ``consts/const.go:156-166`` /
# ``pkg/db/v1beta1/common/const.go``
_ENV_OVERRIDES = (
    ("KATIB_TPU_WORKDIR", ("init", "workdir"), str),
    ("KATIB_TPU_STORE_BACKEND", ("store", "backend"), str),
    ("KATIB_TPU_STORE_PATH", ("store", "path"), str),
    ("KATIB_TPU_DB_HOST", ("store", "host"), str),
    ("KATIB_TPU_DB_PORT", ("store", "port"), int),
    ("KATIB_TPU_DB_DSN", ("store", "dsn"), str),
)


@dataclass
class KatibConfig:
    init: InitConfig = field(default_factory=InitConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    store: StoreConfig = field(default_factory=StoreConfig)

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "KatibConfig":
        _check_keys("top-level", data, ("apiVersion", "kind", "init", "runtime", "store"))
        api = data.get("apiVersion")
        if api is not None and api != "config.katib-tpu.dev/v1":
            raise ConfigError(f"unsupported apiVersion {api!r}")
        return cls(
            init=InitConfig.from_dict(data.get("init") or {}),
            runtime=RuntimeConfig.from_dict(data.get("runtime") or {}),
            store=StoreConfig.from_dict(data.get("store") or {}),
        )

    @classmethod
    def load(cls, path: str | None = None, env: Mapping[str, str] | None = None) -> "KatibConfig":
        """Defaults → YAML file (if given) → ``KATIB_TPU_*`` env overrides."""
        data: dict[str, Any] = {}
        if path is not None:
            with open(path) as f:
                loaded = yaml.safe_load(f) or {}
            if not isinstance(loaded, dict):
                raise ConfigError(f"config file {path} must be a mapping")
            data = loaded
        cfg = cls.from_dict(data)
        env = os.environ if env is None else env
        for var, (section, key), cast in _ENV_OVERRIDES:
            if var in env:
                try:
                    value = cast(env[var])
                except ValueError as e:
                    raise ConfigError(f"bad env override {var}={env[var]!r}") from e
                setattr(getattr(cfg, section), key, value)
        if cfg.store.backend not in StoreConfig._BACKENDS:
            raise ConfigError(
                f"store.backend {cfg.store.backend!r} not in {StoreConfig._BACKENDS}"
            )
        return cfg

    # -- application --------------------------------------------------------

    def apply_to(self, spec: ExperimentSpec) -> ExperimentSpec:
        """Merge registered runtime defaults into an experiment spec: config
        algorithm settings sit under the experiment's own (the reference
        merges service defaults the same way — e.g. DARTS
        ``service.py:118-135``), and collector filter/path fill unset fields."""
        spec = dataclasses.replace(spec) if dataclasses.is_dataclass(spec) else spec
        algo_cfg = self.runtime.algorithms.get(spec.algorithm.name)
        if algo_cfg and algo_cfg.settings:
            merged = {**algo_cfg.settings, **dict(spec.algorithm.settings)}
            spec.algorithm = dataclasses.replace(spec.algorithm, settings=merged)
        if spec.early_stopping is not None:
            es_cfg = self.runtime.early_stopping.get(spec.early_stopping.name)
            if es_cfg:
                merged = {**es_cfg, **dict(spec.early_stopping.settings)}
                spec.early_stopping = dataclasses.replace(
                    spec.early_stopping, settings=merged
                )
        mc = spec.metrics_collector
        mc_cfg = self.runtime.metrics_collectors.get(mc.kind.value)
        if mc_cfg:
            spec.metrics_collector = dataclasses.replace(
                mc,
                filter=mc.filter or mc_cfg.filter,
                path=mc.path or mc_cfg.path,
            )
        return spec

    def mesh_axes_for(self, algorithm: str) -> dict[str, int]:
        algo_cfg = self.runtime.algorithms.get(algorithm)
        if algo_cfg and algo_cfg.mesh_axes:
            axes = dict(algo_cfg.mesh_axes)
        else:
            axes = dict(self.init.mesh_axes)
        return axes

    def make_orchestrator(self, **overrides):
        """Build an Orchestrator wired from this config (store backend,
        workdir, poll interval); ``overrides`` win."""
        from katib_tpu_torch.orchestrator.orchestrator import Orchestrator

        kwargs: dict[str, Any] = dict(
            store=self.store.make_store(),
            workdir=self.init.workdir,
            poll_interval=self.init.poll_interval,
            config=self,
        )
        kwargs.update(overrides)
        return Orchestrator(**kwargs)
