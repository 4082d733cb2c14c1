"""SQLite observation-log backend.

Durable equivalent of the reference DB-manager's MySQL/Postgres table
``observation_logs(trial_name, id, time, metric_name, value)``
(``pkg/db/v1beta1/mysql/init.go:35``) without the standalone daemon: the
orchestrator embeds the store, so the sidecar→gRPC→SQL hop disappears.
Schema keeps an extra ``step`` column because white-box trials report
structured (step, value) points rather than parsed log lines.

Crash-safety contract (the orchestrator's journal makes this store the
default, so it must survive a hard kill mid-report):

- WAL journal mode + ``synchronous=NORMAL``: committed transactions
  survive process death (WAL is fsync'd at commit); readers never block
  on writers;
- ``busy_timeout``: a second process (fsck, the UI backend) polling the
  file does not surface spurious ``database is locked`` errors;
- a ``schema_info`` version row so future migrations can detect what
  they are upgrading;
- exactly-once step rows: ``(trial_name, metric_name, step)`` is unique
  for ``step >= 0`` (white-box structured reports) with last-writer-wins
  upsert — a trial re-run after a crash or retry re-reports the same
  steps idempotently instead of duplicating the series.  Unstepped rows
  (``step = -1``, parsed log lines) keep append semantics, matching the
  reference's raw observation log.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterable

from katib_tpu_torch.core.types import MetricLog
from katib_tpu_torch.store.base import ObservationStore

SCHEMA_VERSION = 2

_SCHEMA = """
CREATE TABLE IF NOT EXISTS observation_logs (
    id          INTEGER PRIMARY KEY AUTOINCREMENT,
    trial_name  TEXT    NOT NULL,
    time        REAL    NOT NULL,
    metric_name TEXT    NOT NULL,
    value       REAL    NOT NULL,
    step        INTEGER NOT NULL DEFAULT -1
);
CREATE INDEX IF NOT EXISTS idx_obs_trial ON observation_logs (trial_name, metric_name, id);
CREATE TABLE IF NOT EXISTS schema_info (
    key   TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
"""

#: partial unique index backing the step-row upsert; created after a
#: dedup pass so pre-v2 databases with duplicate step rows still open
_STEP_INDEX = (
    "CREATE UNIQUE INDEX IF NOT EXISTS idx_obs_step ON observation_logs"
    " (trial_name, metric_name, step) WHERE step >= 0"
)


class SqliteObservationStore(ObservationStore):
    def __init__(self, path: str = ":memory:") -> None:
        # one shared connection guarded by a lock: sqlite serializes writers
        # anyway, and this keeps ':memory:' stores coherent across threads.
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            if path != ":memory:":
                # WAL survives crashes without blocking readers on writers —
                # the durability mode the resume path depends on.  NORMAL
                # syncs the WAL at commit (durable against process death;
                # at most the last commit can be lost to POWER loss, which
                # replay tolerates — the journal is the source of truth
                # for settlement, the store for series points).
                self._conn.execute("PRAGMA journal_mode=WAL")
                self._conn.execute("PRAGMA synchronous=NORMAL")
            # concurrent readers (fsck, UI backend) wait out a writer's
            # commit instead of raising "database is locked"
            self._conn.execute("PRAGMA busy_timeout=5000")
            self._conn.executescript(_SCHEMA)
            self._migrate()
            self._conn.commit()

    def _migrate(self) -> None:
        """Bring a pre-existing database up to SCHEMA_VERSION.  v1 → v2:
        dedup historic (trial, metric, step>=0) rows (newest id wins) then
        add the unique step index that makes re-reports idempotent."""
        row = self._conn.execute(
            "SELECT value FROM schema_info WHERE key='schema_version'"
        ).fetchone()
        version = int(row[0]) if row else 1
        if version < 2:
            self._conn.execute(
                "DELETE FROM observation_logs WHERE step >= 0 AND id NOT IN ("
                " SELECT MAX(id) FROM observation_logs WHERE step >= 0"
                " GROUP BY trial_name, metric_name, step)"
            )
        self._conn.execute(_STEP_INDEX)
        self._conn.execute(
            "INSERT INTO schema_info (key, value) VALUES ('schema_version', ?)"
            " ON CONFLICT(key) DO UPDATE SET value=excluded.value",
            (str(SCHEMA_VERSION),),
        )

    def report(self, trial_name: str, logs: Iterable[MetricLog]) -> None:
        from katib_tpu_torch.utils.faults import crash_point

        rows = [(trial_name, l.timestamp, l.metric_name, l.value, l.step) for l in logs]
        if not rows:
            return
        with self._lock:
            self._conn.executemany(
                "INSERT INTO observation_logs (trial_name, time, metric_name, value, step)"
                " VALUES (?, ?, ?, ?, ?)"
                " ON CONFLICT(trial_name, metric_name, step) WHERE step >= 0"
                " DO UPDATE SET value=excluded.value, time=excluded.time",
                rows,
            )
            # kill window: rows inserted, transaction not yet committed — a
            # crash here must roll back cleanly (WAL), never corrupt the db
            crash_point("store.report")
            self._conn.commit()

    def get(self, trial_name: str, metric_name: str | None = None) -> list[MetricLog]:
        q = (
            "SELECT metric_name, value, time, step FROM observation_logs"
            " WHERE trial_name = ?"
        )
        args: list = [trial_name]
        if metric_name is not None:
            q += " AND metric_name = ?"
            args.append(metric_name)
        q += " ORDER BY id"
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        return [
            MetricLog(metric_name=m, value=v, timestamp=t, step=s) for (m, v, t, s) in rows
        ]

    def delete(self, trial_name: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM observation_logs WHERE trial_name = ?", (trial_name,)
            )
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()
