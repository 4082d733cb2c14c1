"""External-SQL observation-log backend over any DB-API 2.0 connection.

The reference fronts MySQL (``pkg/db/v1beta1/mysql/init.go:35``) and
Postgres (``postgres/init.go:35``) behind its DB-manager daemon with one
table::

    observation_logs(trial_name VARCHAR(255) NOT NULL,
                     id        <auto-increment primary key>,
                     time      DATETIME(6) / TIMESTAMP(6),
                     metric_name VARCHAR(255) NOT NULL,
                     value     TEXT NOT NULL)

This adapter speaks that exact schema through a caller-supplied DB-API
connection (PyMySQL, mysqlclient, psycopg2, or sqlite3 for tests), so a
deployment can point the orchestrator at an existing Katib database and
read/write the same rows the reference's DB-manager would
(``mysql/mysql.go:66-135`` RegisterObservationLog / GetObservationLog /
DeleteObservationLog semantics: time stored as a UTC ``DATETIME(6)``
string, value stored as TEXT, reads ordered by time).

Differences from the in-process backends (``store/sqlite.py``):
- ``step`` is NOT persisted — the reference schema has no step column,
  and schema parity (interoperating with an existing Katib DB) wins;
  round-tripped logs come back with ``step=-1``.
- values are stored as text and parsed on read; rows whose value is not
  numeric (the reference stores e.g. ``Best-Genotype=...`` strings) are
  skipped by ``get`` but preserved in the table, matching how the
  reference's metric math treats unparseable values.

No new dependency: the driver module is the caller's choice (none is
imported here), and the sqlite3 stdlib driver exercises the full code
path in tests (``tests/test_torch_dbapi_store.py``).
"""

from __future__ import annotations

import datetime as _dt
import threading
from typing import Callable, Iterable

from katib_tpu_torch.core.types import MetricLog
from katib_tpu_torch.store.base import ObservationStore

# Reference DDL per engine (mysql/init.go:35, postgres/init.go:35); the
# sqlite variant exists so tests can prove schema compatibility with the
# stdlib driver.
_DDL = {
    "mysql": (
        "CREATE TABLE IF NOT EXISTS observation_logs"
        " (trial_name VARCHAR(255) NOT NULL,"
        " id INT AUTO_INCREMENT PRIMARY KEY,"
        " time DATETIME(6),"
        " metric_name VARCHAR(255) NOT NULL,"
        " value TEXT NOT NULL)"
    ),
    "postgres": (
        "CREATE TABLE IF NOT EXISTS observation_logs"
        " (trial_name VARCHAR(255) NOT NULL,"
        " id serial PRIMARY KEY,"
        " time TIMESTAMP(6),"
        " metric_name VARCHAR(255) NOT NULL,"
        " value TEXT NOT NULL)"
    ),
    "sqlite": (
        "CREATE TABLE IF NOT EXISTS observation_logs"
        " (trial_name VARCHAR(255) NOT NULL,"
        " id INTEGER PRIMARY KEY AUTOINCREMENT,"
        " time DATETIME(6),"
        " metric_name VARCHAR(255) NOT NULL,"
        " value TEXT NOT NULL)"
    ),
}

# the reference's mysqlTimeFmt: microsecond DATETIME as a UTC string
_TIME_FMT = "%Y-%m-%d %H:%M:%S.%f"


def _fmt_time(ts: float) -> str:
    return _dt.datetime.fromtimestamp(ts, tz=_dt.timezone.utc).strftime(_TIME_FMT)


def _parse_time(raw: object) -> float:
    if isinstance(raw, _dt.datetime):
        dt = raw if raw.tzinfo else raw.replace(tzinfo=_dt.timezone.utc)
        return dt.timestamp()
    try:
        return (
            _dt.datetime.strptime(str(raw), _TIME_FMT)
            .replace(tzinfo=_dt.timezone.utc)
            .timestamp()
        )
    except ValueError:
        return 0.0


class DbapiObservationStore(ObservationStore):
    """Reference-schema store over a DB-API connection.

    ``conn``: an open DB-API 2.0 connection, or a zero-arg factory that
    returns one (the factory is called once, lazily).  ``paramstyle``:
    the driver's placeholder style — ``"qmark"`` (sqlite3) or
    ``"format"`` (PyMySQL/mysqlclient/psycopg2); defaults from the
    dialect.  ``init_schema=False`` mirrors the reference's
    ``DB_SKIP_DB_INITIALIZATION`` flag: validate the table exists
    instead of creating it (``mysql/init.go:44-49``).
    """

    def __init__(
        self,
        conn: object | Callable[[], object],
        *,
        dialect: str = "mysql",
        paramstyle: str | None = None,
        init_schema: bool = True,
    ) -> None:
        if dialect not in _DDL:
            raise ValueError(f"unknown dialect {dialect!r}; known: {sorted(_DDL)}")
        # a DB-API connection has .cursor(); anything else callable is
        # treated as a factory (sqlite3 connections are themselves
        # callable, so callable() alone cannot discriminate)
        self._conn = conn if hasattr(conn, "cursor") else conn()
        self._lock = threading.RLock()
        self._ph = {
            "qmark": "?",
            "format": "%s",
        }[paramstyle or ("qmark" if dialect == "sqlite" else "format")]
        with self._lock:
            cur = self._conn.cursor()
            try:
                if init_schema:
                    cur.execute(_DDL[dialect])
                else:
                    cur.execute(
                        "SELECT trial_name, id, time, metric_name, value"
                        " FROM observation_logs LIMIT 1"
                    )
                    cur.fetchall()
                self._conn.commit()
            finally:
                cur.close()

    def _sql(self, q: str) -> str:
        return q.replace("?", self._ph)

    def report(self, trial_name: str, logs: Iterable[MetricLog]) -> None:
        rows = [
            (trial_name, _fmt_time(l.timestamp), l.metric_name, str(l.value))
            for l in logs
        ]
        if not rows:
            return
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.executemany(
                    self._sql(
                        "INSERT INTO observation_logs"
                        " (trial_name, time, metric_name, value)"
                        " VALUES (?, ?, ?, ?)"
                    ),
                    rows,
                )
                self._conn.commit()
            finally:
                cur.close()

    def get(
        self,
        trial_name: str,
        metric_name: str | None = None,
        start_time: float | None = None,
        end_time: float | None = None,
    ) -> list[MetricLog]:
        q = (
            "SELECT time, metric_name, value FROM observation_logs"
            " WHERE trial_name = ?"
        )
        args: list = [trial_name]
        if metric_name is not None:
            q += " AND metric_name = ?"
            args.append(metric_name)
        # the reference's optional start/end window (mysql.go:115-132)
        if start_time is not None:
            q += " AND time >= ?"
            args.append(_fmt_time(start_time))
        if end_time is not None:
            q += " AND time <= ?"
            args.append(_fmt_time(end_time))
        q += " ORDER BY time"
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.execute(self._sql(q), args)
                rows = cur.fetchall()
            finally:
                cur.close()
        out: list[MetricLog] = []
        for t, m, v in rows:
            try:
                value = float(v)
            except (TypeError, ValueError):
                continue  # non-numeric value rows (see module doc)
            out.append(MetricLog(metric_name=m, value=value, timestamp=_parse_time(t)))
        return out

    def delete(self, trial_name: str) -> None:
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.execute(
                    self._sql("DELETE FROM observation_logs WHERE trial_name = ?"),
                    (trial_name,),
                )
                self._conn.commit()
            finally:
                cur.close()

    def close(self) -> None:
        with self._lock:
            self._conn.close()
