"""Crash-consistent experiment event journal.

``status.json`` is a rewrite-the-world snapshot: every publish replaces the
whole file, so the instant before the rename there is a window where the
only complete copy of the experiment's history is in process memory.  The
reference never has this problem — its state lives in CRs on the API
server plus the suggestion PVC (``experiment_controller.go`` re-open,
``FromVolume``) and survives any controller death.  This module is the
single-process analog: an append-only JSONL journal of state transitions
that is the durable source of truth for resume, while ``status.json``
remains a derived view for the CLI/UI.

Format — one JSON object per line::

    {"seq": 17, "ts": ..., "event": "settled", "trial": "exp-a1b2",
     "epoch": 0, "data": {...}, "crc": "9f3a01c2"}

- ``seq`` is a strictly-increasing sequence number (the journal's clock —
  also the fence the suggester pickle carries, see below);
- ``event`` is one of ``proposed / queued / started / reported / settled /
  retried / drained / experiment`` (``queued`` is the async scheduler's
  queue-handoff record: the trial left the suggest queue and entered a
  packing bucket, so crash/resume can restore all three loops' in-flight
  state);
- ``epoch`` is the trial's attempt epoch (``retry_count`` at append time):
  settlement is exactly-once per ``(trial, epoch)`` key, so a record
  duplicated by a crash-then-resume cycle is dropped on replay, counted in
  ``katib_settlement_duplicates_total``;
- ``crc`` is a CRC-32 of the record minus the crc field itself (canonical
  sorted-key JSON), so a torn or bit-flipped line is detected, not trusted.

Durability: every append is flushed and fsync'd before the caller
proceeds.  A crash mid-append leaves a torn tail; loading tolerates it
(the valid prefix wins, the torn bytes are truncated away on open — the
same rule ``compile/registry.py`` applies to its shape registry).

Compaction: every ``snapshot_every`` settlements the owner writes a
checksummed snapshot (``snapshot-<seq>.json``, durable via
``fsio.atomic_replace``) and the journal is truncated to records newer
than the snapshot, so replay cost stays bounded by the snapshot interval
instead of experiment length.  The ordering makes the crash windows safe:
snapshot first (journal still covers everything), truncate second
(records ≤ snapshot seq are redundant; replay drops them as
already-applied if a crash leaves them behind).

Everything here is stdlib-only and jax-free.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from dataclasses import dataclass, field

from katib_tpu_torch.utils.clock import get_clock
from katib_tpu_torch.utils.fsio import atomic_replace, fsync_dir

# Durability kill switch for the virtual-time simulator (katib_tpu_torch/sim):
# per-append fsync costs nothing in virtual time but dominates wall time at
# 50k trials.  Production never sets this; the crash windows stay identical
# either way (bytes are still written + flushed before the crash point).
SYNC_ENV = "KATIB_JOURNAL_SYNC"


def _sync_enabled() -> bool:
    return os.environ.get(SYNC_ENV, "1") != "0"


JOURNAL_FILE = "journal.jsonl"
SNAPSHOT_PREFIX = "snapshot-"

#: trial-terminal events subject to exactly-once replay
SETTLED_EVENT = "settled"

#: every event the replayer understands, for fsck and docs
EVENTS = (
    "proposed",
    "queued",
    "started",
    "reported",
    "settled",
    "retried",
    "drained",
    "experiment",
    # supervisor audit trail: loop restarts / fallback decisions (no trial
    # payload; replay merges any "exp" data and otherwise skips them)
    "supervisor",
)


def journal_path(workdir: str, experiment_name: str) -> str:
    return os.path.join(workdir, experiment_name, JOURNAL_FILE)


def _crc(record: dict) -> str:
    """CRC-32 (hex) over the canonical serialization sans the crc field."""
    body = {k: v for k, v in record.items() if k != "crc"}
    raw = json.dumps(body, sort_keys=True, default=str).encode()
    return f"{zlib.crc32(raw) & 0xFFFFFFFF:08x}"


def _encode_record(rec: dict) -> str:
    """One-pass writer-side serialization: the canonical sort_keys JSON of
    the crc-less record with the crc spliced onto the end.  The reader's
    :func:`_crc` recomputes from the *parsed* dict with ``sort_keys=True``,
    so field order on disk is irrelevant — this is byte-compatible with the
    verification path while serializing each record once instead of twice
    (the append path dominates sweep-scale runs)."""
    raw = json.dumps(rec, sort_keys=True, default=str)
    crc = f"{zlib.crc32(raw.encode()) & 0xFFFFFFFF:08x}"
    return f'{raw[:-1]}, "crc": "{crc}"}}\n'


def _snapshot_name(seq: int) -> str:
    return f"{SNAPSHOT_PREFIX}{seq:012d}.json"


def _snapshot_seq(filename: str) -> int | None:
    stem = filename[len(SNAPSHOT_PREFIX) : -len(".json")]
    try:
        return int(stem)
    except ValueError:
        return None


def list_snapshots(exp_dir: str) -> list[tuple[int, str]]:
    """(seq, path) for every well-named snapshot file, oldest first."""
    out = []
    try:
        names = os.listdir(exp_dir)
    except OSError:
        return []
    for name in names:
        if name.startswith(SNAPSHOT_PREFIX) and name.endswith(".json"):
            seq = _snapshot_seq(name)
            if seq is not None:
                out.append((seq, os.path.join(exp_dir, name)))
    out.sort()
    return out


def load_snapshot(path: str) -> tuple[int, dict] | None:
    """(seq, state) when the snapshot parses AND its checksum verifies;
    None otherwise (fsck quarantines such files)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(doc, dict) or "state" not in doc or "seq" not in doc:
        return None
    want = doc.get("crc")
    got = f"{zlib.crc32(json.dumps(doc['state'], sort_keys=True, default=str).encode()) & 0xFFFFFFFF:08x}"
    if want != got:
        return None
    return int(doc["seq"]), doc["state"]


@dataclass
class ScanResult:
    """What one pass over a journal file found."""

    records: list[dict] = field(default_factory=list)
    #: byte offset of the end of the last VALID record (truncation point)
    valid_bytes: int = 0
    #: trailing bytes that failed to parse/verify (torn tail), 0 if clean
    torn_bytes: int = 0
    #: mid-file records dropped for bad checksum / non-monotonic seq
    bad_records: int = 0


def scan_journal(path: str) -> ScanResult:
    """Read every verifiable record in order.  A bad line mid-file is
    dropped (counted); a bad TRAILING region is the torn tail a crash
    mid-append leaves — its byte extent is reported so the caller (open /
    fsck) can truncate it away."""
    res = ScanResult()
    try:
        f = open(path, "rb")
    except OSError:
        return res
    last_seq = 0
    with f:
        offset = 0
        trailing_bad = 0
        for raw in f:
            line_len = len(raw)
            line = raw.decode("utf-8", errors="replace").strip()
            offset += line_len
            if not line:
                res.valid_bytes = offset if not trailing_bad else res.valid_bytes
                continue
            ok = False
            try:
                rec = json.loads(line)
                if (
                    isinstance(rec, dict)
                    and rec.get("crc") == _crc(rec)
                    and isinstance(rec.get("seq"), int)
                ):
                    ok = True
            except (json.JSONDecodeError, TypeError):
                ok = False
            # a record must also end in a newline: a valid-looking JSON line
            # at EOF without one may still be mid-write
            if ok and not raw.endswith(b"\n"):
                ok = False
            if ok and rec["seq"] <= last_seq:
                # duplicate / out-of-order (e.g. re-appended after a partial
                # compaction): drop, count, keep scanning
                res.bad_records += 1
                res.valid_bytes = offset
                continue
            if ok:
                last_seq = rec["seq"]
                res.records.append(rec)
                res.valid_bytes = offset
                if trailing_bad:
                    # bad region was mid-file after all
                    res.bad_records += trailing_bad
                    trailing_bad = 0
            else:
                trailing_bad += 1
        res.torn_bytes = offset - res.valid_bytes if trailing_bad else 0
    return res


class ExperimentJournal:
    """Append-only event log for one experiment.  Thread-safe: the
    orchestrator appends from the run loop AND from trial pool threads
    (retry-budget records)."""

    def __init__(
        self, workdir: str, experiment_name: str, snapshot_every: int = 32
    ) -> None:
        self.exp_dir = os.path.join(workdir, experiment_name)
        os.makedirs(self.exp_dir, exist_ok=True)
        self.path = os.path.join(self.exp_dir, JOURNAL_FILE)
        self.snapshot_every = max(1, snapshot_every)
        self._lock = threading.Lock()
        self._settled_since_snapshot = 0
        # recover the sequence clock from disk (resume case) and drop any
        # torn tail NOW, so this process appends after the valid prefix
        # instead of concatenating onto garbage
        seq = 0
        if os.path.exists(self.path):
            scan = scan_journal(self.path)
            if scan.records:
                seq = scan.records[-1]["seq"]
            if scan.torn_bytes:
                with open(self.path, "rb+") as f:
                    f.truncate(scan.valid_bytes)
                    f.flush()
                    os.fsync(f.fileno())
        for snap_seq, _ in list_snapshots(self.exp_dir):
            seq = max(seq, snap_seq)
        self.seq = seq
        self._sync = _sync_enabled()
        self._f = open(self.path, "a", encoding="utf-8")

    # -- writing -----------------------------------------------------------

    def append(
        self,
        event: str,
        trial: str | None = None,
        epoch: int = 0,
        data: dict | None = None,
    ) -> int:
        """Durably append one record; returns its seq."""
        from katib_tpu_torch.utils.faults import crash_point

        with self._lock:
            self.seq += 1
            rec = {
                "seq": self.seq,
                "ts": round(get_clock().time(), 3),
                "event": event,
                "trial": trial,
                "epoch": int(epoch),
                "data": data or {},
            }
            self._f.write(_encode_record(rec))
            self._f.flush()
            # the deterministic kill window: bytes written, not yet fsync'd —
            # a crash here is exactly the torn tail the loader tolerates
            crash_point("journal.append")
            if self._sync:
                os.fsync(self._f.fileno())
            if event == SETTLED_EVENT:
                self._settled_since_snapshot += 1
            return self.seq

    def append_group(
        self, records: list[tuple[str, str | None, int, dict | None]]
    ) -> int:
        """Durably append several records with ONE fsync (the async
        scheduler's batch hand-offs: 32 ``proposed``/``queued`` records cost
        one disk sync instead of 32).  Each record is still written and
        flushed individually — the per-record crash window (bytes written,
        not yet fsync'd) is identical to sequential :meth:`append` calls —
        only the final durability barrier is amortized.  Returns the last
        seq."""
        from katib_tpu_torch.utils.faults import crash_point

        with self._lock:
            for event, trial, epoch, data in records:
                self.seq += 1
                rec = {
                    "seq": self.seq,
                    "ts": round(get_clock().time(), 3),
                    "event": event,
                    "trial": trial,
                    "epoch": int(epoch),
                    "data": data or {},
                }
                self._f.write(_encode_record(rec))
                self._f.flush()
                crash_point("journal.append")
                if event == SETTLED_EVENT:
                    self._settled_since_snapshot += 1
            if self._sync:
                os.fsync(self._f.fileno())
            return self.seq

    def maybe_compact(self, state_fn) -> bool:
        """Snapshot + truncate when enough settlements accumulated.
        ``state_fn`` lazily produces the full experiment state dict (the
        ``status.py`` ``experiment_to_dict`` shape)."""
        with self._lock:
            if self._settled_since_snapshot < self.snapshot_every:
                return False
        self.snapshot(state_fn())
        return True

    def snapshot(self, state: dict) -> str:
        """Durably write a checksummed snapshot at the current seq, then
        compact: truncate the journal (its records are now ≤ snapshot seq)
        and prune older snapshots."""
        with self._lock:
            seq = self.seq
            doc = {
                "seq": seq,
                "crc": f"{zlib.crc32(json.dumps(state, sort_keys=True, default=str).encode()) & 0xFFFFFFFF:08x}",
                "state": state,
            }
            path = os.path.join(self.exp_dir, _snapshot_name(seq))
            atomic_replace(
                path,
                json.dumps(doc, default=str).encode(),
                prefix=".snap-",
                crash_site="journal.snapshot",
            )
            # snapshot durable → the journal prefix is redundant; truncate.
            # A crash between these two steps only leaves already-applied
            # records, which replay drops by seq.
            self._f.close()
            with open(self.path, "w") as f:
                f.flush()
                os.fsync(f.fileno())
            fsync_dir(self.exp_dir)
            self._f = open(self.path, "a", encoding="utf-8")
            for old_seq, old_path in list_snapshots(self.exp_dir):
                if old_seq < seq:
                    try:
                        os.unlink(old_path)
                    except OSError:
                        pass
            self._settled_since_snapshot = 0
            return path

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            try:
                self._f.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


@dataclass
class ReplayStats:
    applied: int = 0
    duplicates: int = 0       # settled records dropped by the (trial, epoch) key
    stale: int = 0            # records at/below the snapshot seq (post-crash leftovers)
    bad_records: int = 0
    torn_bytes: int = 0
    last_seq: int = 0
    #: highest seq among applied *settled* records — the suggester fence
    #: threshold: a pickle whose fence is older than this is missing
    #: observations and must be rebuilt from trial history
    last_settled_seq: int = 0
    snapshot_seq: int | None = None


def _blank_state(name: str | None) -> dict:
    return {
        "name": name,
        "condition": "Created",
        "message": "",
        "start_time": 0.0,
        "completion_time": 0.0,
        "algorithm_settings": {},
        "optimal": None,
        "optimal_history": [],
        "trials": {},
    }


def _apply(state: dict, rec: dict, stats: ReplayStats, settled_keys: set) -> None:
    event = rec.get("event")
    data = rec.get("data") or {}
    trial = rec.get("trial")
    if event == SETTLED_EVENT:
        key = (trial, rec.get("epoch", 0))
        if key in settled_keys:
            stats.duplicates += 1
            return
        settled_keys.add(key)
        stats.last_settled_seq = max(stats.last_settled_seq, rec.get("seq", 0))
    # trial payload: the full trial_to_dict dict under "trial"
    tdata = data.get("trial")
    if trial is not None and isinstance(tdata, dict):
        state.setdefault("trials", {})[trial] = tdata
    elif trial is not None and event == "reported" and isinstance(data.get("observation"), list):
        t = state.setdefault("trials", {}).get(trial)
        if t is not None:
            t["observation"] = data["observation"]
    # experiment-level payload: merged last-writer-wins
    edata = data.get("exp")
    if isinstance(edata, dict):
        for k, v in edata.items():
            state[k] = v
    if event == "experiment":
        for k in ("name", "start_time", "algorithm"):
            if k in data:
                state[k] = data[k]
    stats.applied += 1


def replay_journal(
    workdir: str, experiment_name: str
) -> tuple[dict | None, ReplayStats]:
    """Rebuild the status-dict view of an experiment from its snapshot +
    journal suffix.  Returns ``(None, stats)`` when neither exists.

    Exactly-once settlement: records are applied in seq order; a settled
    record whose ``(trial, epoch)`` key was already settled — or any record
    at/below the snapshot's seq — is dropped and counted, never re-applied.
    """
    exp_dir = os.path.join(workdir, experiment_name)
    stats = ReplayStats()
    state: dict | None = None
    base_seq = 0
    # newest verifiable snapshot wins; unverifiable ones are skipped here
    # (fsck quarantines them) and replay falls back to the full log
    for seq, path in reversed(list_snapshots(exp_dir)):
        loaded = load_snapshot(path)
        if loaded is not None:
            base_seq, state = loaded
            stats.snapshot_seq = base_seq
            break
    scan = scan_journal(journal_path(workdir, experiment_name))
    stats.bad_records = scan.bad_records
    stats.torn_bytes = scan.torn_bytes
    if state is None and not scan.records:
        return None, stats
    if state is None:
        state = _blank_state(experiment_name)
    # seed the settled-key set from the snapshot's TERMINAL trials so
    # post-compaction leftovers can't double-settle; non-terminal trials
    # stay unkeyed — their genuine settlement is still ahead in the log
    _TERMINAL = {
        "Succeeded", "Killed", "Failed", "EarlyStopped", "MetricsUnavailable"
    }
    settled_keys: set = set()
    for tname, tdata in (state.get("trials") or {}).items():
        if isinstance(tdata, dict) and tdata.get("condition") in _TERMINAL:
            settled_keys.add((tname, int(tdata.get("retry_count") or 0)))
    stats.last_settled_seq = base_seq
    stats.last_seq = base_seq
    for rec in scan.records:
        if rec["seq"] <= base_seq:
            stats.stale += 1
            continue
        _apply(state, rec, stats, settled_keys)
        stats.last_seq = rec["seq"]
    return state, stats


def last_settled_seq(workdir: str, experiment_name: str) -> int:
    """The fence threshold: highest seq the journal proves settled work at.
    0 when no journal exists (fencing disabled)."""
    _, stats = replay_journal(workdir, experiment_name)
    return stats.last_settled_seq
