"""The port's DB-API observation store (``katib_tpu_torch/store/dbapi.py``)
against the JAX package's, over the stdlib ``sqlite3`` driver.

The cases of ``tests/test_dbapi_store.py`` run through both stores and
must agree; rows written by either store read back in the other (the
schema is the reference's ``observation_logs``); and ``StoreConfig``
builds the store for ``mysql`` and ``postgres`` through whichever driver
module is importable (a stand-in module over ``sqlite3`` here), and names
the drivers when none is."""

from __future__ import annotations

import sqlite3
import sys
import types

import pytest

from katib_tpu.core import types as jtypes
from katib_tpu.core.config import StoreConfig as JStoreConfig
from katib_tpu.store.dbapi import DbapiObservationStore as JDbapiStore
from katib_tpu_torch.core import types as ttypes
from katib_tpu_torch.core.config import ConfigError, StoreConfig, _parse_dsn
from katib_tpu_torch.store.dbapi import DbapiObservationStore

STORES = {"jax": (JDbapiStore, jtypes), "torch": (DbapiObservationStore, ttypes)}


def _store(pkg: str, conn=None, **kw):
    cls, _ = STORES[pkg]
    conn = conn or sqlite3.connect(":memory:", check_same_thread=False)
    return cls(conn, dialect="sqlite", **kw), conn


def logs(pkg: str, store, trial: str, *args, **kw):
    return [(l.metric_name, l.value, l.timestamp, l.step) for l in store.get(trial, *args, **kw)]


def case_roundtrip(pkg):
    t = STORES[pkg][1]
    store, _ = _store(pkg)
    store.report("trial-a", [
        t.MetricLog(metric_name="accuracy", value=0.5, timestamp=100.0),
        t.MetricLog(metric_name="accuracy", value=0.75, timestamp=200.0),
        t.MetricLog(metric_name="loss", value=1.25, timestamp=150.0),
    ])
    out = [logs(pkg, store, "trial-a", "accuracy"), logs(pkg, store, "trial-a")]
    store.delete("trial-a")
    return out + [logs(pkg, store, "trial-a")]


def case_schema(pkg):
    store, conn = _store(pkg)
    store.report_point("t", "m", 0.9)
    cols = [r[1] for r in conn.execute("PRAGMA table_info(observation_logs)")]
    t, v = conn.execute("SELECT time, value FROM observation_logs").fetchone()
    assert cols == ["trial_name", "id", "time", "metric_name", "value"]
    assert isinstance(v, str) and float(v) == 0.9
    assert len(t.split(" ")) == 2 and "." in t
    return cols, v


def case_reference_rows(pkg):
    store, conn = _store(pkg)
    conn.executemany(
        "INSERT INTO observation_logs (trial_name, time, metric_name, value) VALUES (?, ?, ?, ?)",
        [("ext-trial", "2024-01-01 00:00:00.000000", "accuracy", "0.91"),
         ("ext-trial", "2024-01-01 00:00:01.500000", "accuracy", "0.93"),
         ("ext-trial", "2024-01-01 00:00:02.000000", "genotype", "Genotype(normal=[...])")])
    conn.commit()
    return [logs(pkg, store, "ext-trial", "accuracy"), logs(pkg, store, "ext-trial", "genotype")]


def case_time_window(pkg):
    t = STORES[pkg][1]
    store, _ = _store(pkg)
    for i in range(5):
        store.report("t", [t.MetricLog(metric_name="m", value=float(i), timestamp=100.0 + i)])
    return logs(pkg, store, "t", "m", start_time=101.0, end_time=103.0)


def case_ordered_by_time(pkg):
    t = STORES[pkg][1]
    store, _ = _store(pkg)
    store.report("t", [t.MetricLog(metric_name="m", value=2.0, timestamp=200.0),
                       t.MetricLog(metric_name="m", value=1.0, timestamp=100.0)])
    return logs(pkg, store, "t", "m")


def case_skip_init(pkg):
    cls, _ = STORES[pkg]
    conn = sqlite3.connect(":memory:", check_same_thread=False)
    cls(conn, dialect="sqlite")
    cls(conn, dialect="sqlite", init_schema=False)
    empty = sqlite3.connect(":memory:", check_same_thread=False)
    with pytest.raises(sqlite3.OperationalError):
        cls(empty, dialect="sqlite", init_schema=False)
    return True


def case_strategies(pkg):
    t = STORES[pkg][1]
    store, _ = _store(pkg)
    for i, v in enumerate([0.3, 0.9, 0.7]):
        store.report("t", [t.MetricLog(metric_name="accuracy", value=v, timestamp=float(i))])
    obj = t.ObjectiveSpec(
        type=t.ObjectiveType.MAXIMIZE, objective_metric_name="accuracy",
        metric_strategies=(t.MetricStrategy("accuracy", t.MetricStrategyType.MAX),))
    (m,) = [m for m in store.observation_for("t", obj).metrics if m.name == "accuracy"]
    return m.value, m.latest, m.min, m.max


def case_unknown_dialect(pkg):
    cls, _ = STORES[pkg]
    with pytest.raises(ValueError) as info:
        cls(sqlite3.connect(":memory:"), dialect="oracle")
    return str(info.value)


def case_factory(pkg):
    cls, _ = STORES[pkg]
    store = cls(lambda: sqlite3.connect(":memory:", check_same_thread=False), dialect="sqlite")
    store.report_point("t", "m", 1.5)
    return [l.value for l in store.get("t", "m")]


CASES = {f.__name__.removeprefix("case_"): f for f in (
    case_roundtrip, case_schema, case_reference_rows, case_time_window, case_ordered_by_time,
    case_skip_init, case_strategies, case_unknown_dialect, case_factory)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_store_matches_the_jax_store(case):
    assert CASES[case]("torch") == CASES[case]("jax")


def test_the_jax_cases_hold_for_the_port():
    assert case_roundtrip("torch") == [
        [("accuracy", 0.5, 100.0, -1), ("accuracy", 0.75, 200.0, -1)],
        [("accuracy", 0.5, 100.0, -1), ("loss", 1.25, 150.0, -1),
         ("accuracy", 0.75, 200.0, -1)],
        [],
    ]
    assert [v for _, v, _, _ in case_time_window("torch")] == [1.0, 2.0, 3.0]
    assert [v for _, v, _, _ in case_ordered_by_time("torch")] == [1.0, 2.0]
    assert case_strategies("torch")[:3] == (0.9, 0.7, 0.3)
    (acc, gen) = case_reference_rows("torch")
    assert [v for _, v, _, _ in acc] == [0.91, 0.93] and acc[0][2] > 0 and gen == []


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_rows_written_by_one_package_read_back_in_the_other(writer, reader, tmp_path):
    """One database file: the writer's store reports, the reader's store
    opens the same table without initialising it and reads every row."""
    path = str(tmp_path / "katib.db")
    wt = STORES[writer][1]
    w, wconn = _store(writer, sqlite3.connect(path, check_same_thread=False))
    rows = [wt.MetricLog(metric_name=m, value=v, timestamp=1.7e9 + i)
            for i, (m, v) in enumerate([("accuracy", 0.25), ("loss", 2.5), ("accuracy", 0.5)])]
    w.report("trial-x", rows)
    w.report("trial-y", rows[:1])
    wconn.close()
    r, _ = _store(reader, sqlite3.connect(path, check_same_thread=False), init_schema=False)
    assert logs(reader, r, "trial-x") == [
        (l.metric_name, l.value, l.timestamp, -1) for l in rows]
    assert logs(reader, r, "trial-y", "accuracy") == [("accuracy", 0.25, 1.7e9, -1)]
    r.delete("trial-x")
    again, _ = _store(writer, sqlite3.connect(path, check_same_thread=False), init_schema=False)
    assert logs(writer, again, "trial-x") == [] and len(logs(writer, again, "trial-y")) == 1


# -- StoreConfig: the mysql/postgres backends ---------------------------------


@pytest.mark.parametrize("dsn,port", [
    ("katib:secret@db.example:3307/katib", 3306), ("u:p@h/katib", 5432),
    ("", 3306), ("nohost", 3306), ("u:p@/db", 3306), ("u:p@h:port/db", 3306), ("u:p@h:1", 3306),
])
def test_dsn_parses_as_in_the_jax_config(dsn, port):
    from katib_tpu.core.config import ConfigError as JConfigError
    from katib_tpu.core.config import _parse_dsn as j_parse_dsn

    try:
        want = j_parse_dsn(dsn, port)
    except JConfigError as e:
        with pytest.raises(ConfigError) as info:
            _parse_dsn(dsn, port)
        assert str(info.value) == str(e)
    else:
        assert _parse_dsn(dsn, port) == want


@pytest.mark.parametrize("backend,drivers", [("mysql", ("pymysql", "MySQLdb")),
                                             ("postgres", ("psycopg2", "pg8000"))])
def test_make_store_without_a_driver_names_the_drivers(backend, drivers, monkeypatch):
    for name in drivers:
        monkeypatch.setitem(sys.modules, name, None)  # not importable
    cfg = StoreConfig(backend=backend, dsn="u:p@h/katib")
    with pytest.raises(ConfigError) as got:
        cfg.make_store()
    with pytest.raises(Exception) as want:
        JStoreConfig(backend=backend, dsn="u:p@h/katib").make_store()
    assert str(got.value) == str(want.value)
    assert all(name in str(got.value) for name in drivers)


@pytest.mark.parametrize("backend,driver,port", [("mysql", "MySQLdb", 3306),
                                                 ("postgres", "pg8000", 5432)])
def test_make_store_builds_the_dbapi_store(backend, driver, port, monkeypatch, tmp_path):
    """The second driver of each backend stands in as a module whose
    ``connect`` opens sqlite3 (``format`` placeholders translated): the
    store is built lazily from the DSN's parts and reports and reads."""
    calls = []

    class Cursor:
        def __init__(self, cur):
            self._cur = cur

        def execute(self, q, args=()):
            return self._cur.execute(q.replace("%s", "?"), args)

        def executemany(self, q, rows):
            return self._cur.executemany(q.replace("%s", "?"), rows)

        def __getattr__(self, name):
            return getattr(self._cur, name)

    class Conn:
        def __init__(self, conn):
            self._conn = conn

        def cursor(self):
            return Cursor(self._conn.cursor())

        def __getattr__(self, name):
            return getattr(self._conn, name)

    def connect(**kw):
        calls.append(kw)
        # sqlite reads both dialects' DDL (AUTO_INCREMENT and serial parse
        # as type names)
        return Conn(sqlite3.connect(str(tmp_path / "db.sqlite"), check_same_thread=False))

    module = types.ModuleType(driver)
    module.connect = connect
    first = "pymysql" if backend == "mysql" else "psycopg2"
    monkeypatch.setitem(sys.modules, first, None)
    monkeypatch.setitem(sys.modules, driver, module)
    store = StoreConfig.from_dict({"backend": backend, "dsn": "katib:pw@db/katib"}).make_store()
    assert isinstance(store, DbapiObservationStore)
    assert calls == [dict(user="katib", password="pw", host="db", port=port, database="katib")]
    store.report_point("t", "accuracy", 0.5)
    assert [(l.metric_name, l.value) for l in store.get("t")] == [("accuracy", 0.5)]


def test_store_config_accepts_the_sql_backends():
    cfg = StoreConfig.from_dict({"backend": "mysql", "dsn": "u:p@h:3306/katib"})
    assert cfg.backend == "mysql" and cfg.dsn == "u:p@h:3306/katib"
    assert StoreConfig.from_dict({"backend": "postgres", "dsn": "u:p@h/katib"}).backend == "postgres"
