"""Validate and repair an experiment directory — ``katib-tpu fsck``.

The crash-consistency story (orchestrator/journal.py) guarantees a killed
process leaves a *recoverable* directory, not a pristine one: the journal
may end in a torn tail, a snapshot temp file may have been renamed but
never verified, the suggester pickle may be fenced behind the journal.
``fsck`` is the offline half of that contract — it walks one experiment
dir, verifies every durable artifact, repairs what is mechanically
repairable, and reports what resume will rebuild:

- **journal**: every record's checksum and seq monotonicity is verified;
  a torn tail (crash mid-append) is truncated to the valid prefix;
  mid-file corruption is reported (replay already skips it);
- **snapshots**: each ``snapshot-<seq>.json`` must parse and match its
  embedded checksum; unverifiable ones are quarantined (renamed to
  ``*.quarantined``) so replay can never trust them;
- **suggester fence**: the pickle's recorded fence is compared against
  the journal's last settled seq — a mismatch is *reported*, not
  repaired (resume rebuilds the suggester from trial history; deleting
  the pickle here would destroy post-mortem evidence);
- **status.json**: must parse; a corrupt one is reported (the journal
  supersedes it for resume, so this is not fatal).

Repairs bump ``katib_fsck_repairs_total``.  The CLI exits 0 when the
directory is consistent AFTER repairs, 1 when damage remains that fsck
cannot mechanically fix (or when ``--dry-run`` found repairable damage).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from katib_tpu_torch.orchestrator import journal as jr
from katib_tpu_torch.orchestrator.status import STATUS_FILE


@dataclass
class FsckReport:
    exp_dir: str = ""
    journal_records: int = 0
    torn_tail_bytes: int = 0
    bad_records: int = 0
    snapshots_ok: int = 0
    snapshots_quarantined: list[str] = field(default_factory=list)
    #: "ok" | "stale" | "ahead" | "unfenced" | "absent" | "no-journal"
    fence: str = "no-journal"
    status_json: str = "absent"  # "ok" | "corrupt" | "absent"
    repairs: list[str] = field(default_factory=list)
    problems: list[str] = field(default_factory=list)

    def ok(self) -> bool:
        """Consistent after repairs: nothing left that resume cannot
        handle.  A stale fence and a corrupt status.json are NOT failures
        — resume rebuilds both from the journal — but they are reported."""
        return not self.problems

    def lines(self) -> list[str]:
        out = [f"fsck {self.exp_dir}"]
        out.append(
            f"  journal: {self.journal_records} record(s) verified, "
            f"{self.bad_records} bad record(s) skipped, "
            f"torn tail {self.torn_tail_bytes} byte(s)"
        )
        out.append(
            f"  snapshots: {self.snapshots_ok} verified, "
            f"{len(self.snapshots_quarantined)} quarantined"
        )
        out.append(f"  suggester fence: {self.fence}")
        out.append(f"  status.json: {self.status_json}")
        for r in self.repairs:
            out.append(f"  repaired: {r}")
        for p in self.problems:
            out.append(f"  PROBLEM: {p}")
        out.append("  result: " + ("consistent" if self.ok() else "INCONSISTENT"))
        return out


def fsck_experiment(exp_dir: str, repair: bool = True) -> FsckReport:
    """Validate (and with ``repair`` fix) one experiment directory."""
    from katib_tpu_torch.utils import observability as obs

    exp_dir = os.path.abspath(exp_dir)
    report = FsckReport(exp_dir=exp_dir)
    if not os.path.isdir(exp_dir):
        report.problems.append(f"not a directory: {exp_dir}")
        return report
    workdir, name = os.path.split(exp_dir.rstrip(os.sep))

    # -- journal -----------------------------------------------------------
    jpath = jr.journal_path(workdir, name)
    has_journal = os.path.exists(jpath)
    if has_journal:
        scan = jr.scan_journal(jpath)
        report.journal_records = len(scan.records)
        report.bad_records = scan.bad_records
        report.torn_tail_bytes = scan.torn_bytes
        if scan.torn_bytes:
            if repair:
                with open(jpath, "rb+") as f:
                    f.truncate(scan.valid_bytes)
                    f.flush()
                    os.fsync(f.fileno())
                report.repairs.append(
                    f"truncated torn journal tail ({scan.torn_bytes} bytes)"
                )
                obs.fsck_repairs.inc()
            else:
                report.problems.append(
                    f"torn journal tail ({scan.torn_bytes} bytes); rerun "
                    "without --dry-run to truncate"
                )
        if scan.bad_records:
            # replay skips them, but mid-file corruption means records were
            # lost — surface it, nothing mechanical can restore them
            report.problems.append(
                f"{scan.bad_records} corrupt mid-file journal record(s) "
                "(skipped by replay; their transitions are lost)"
            )

    # -- snapshots ---------------------------------------------------------
    for seq, path in jr.list_snapshots(exp_dir):
        if jr.load_snapshot(path) is not None:
            report.snapshots_ok += 1
            continue
        if repair:
            target = path + ".quarantined"
            suffix = 0
            while os.path.exists(target):
                suffix += 1
                target = f"{path}.quarantined.{suffix}"
            os.replace(path, target)
            report.snapshots_quarantined.append(os.path.basename(target))
            report.repairs.append(
                f"quarantined unverifiable snapshot {os.path.basename(path)}"
            )
            obs.fsck_repairs.inc()
        else:
            report.problems.append(
                f"unverifiable snapshot {os.path.basename(path)}; rerun "
                "without --dry-run to quarantine"
            )

    # -- suggester fence ---------------------------------------------------
    from katib_tpu_torch.orchestrator.resume import (
        read_suggester_fence,
        suggester_state_path,
    )

    if not has_journal and not jr.list_snapshots(exp_dir):
        report.fence = "no-journal"
    elif not os.path.exists(suggester_state_path(workdir, name)):
        report.fence = "absent"
    else:
        fence = read_suggester_fence(workdir, name)
        settled = jr.last_settled_seq(workdir, name)
        if fence is None:
            report.fence = "unfenced (legacy pickle; resume treats it as stale)"
        elif fence < settled:
            report.fence = (
                f"stale (pickle fence {fence} < journal settled seq {settled}; "
                "resume rebuilds the suggester from trial history)"
            )
        elif settled == 0 and fence > 0 and report.journal_records == 0:
            report.fence = (
                f"ahead (pickle fence {fence} but journal is empty — journal "
                "was truncated or replaced; resume rebuilds from history)"
            )
        else:
            report.fence = "ok"

    # -- status.json -------------------------------------------------------
    spath = os.path.join(exp_dir, STATUS_FILE)
    if os.path.exists(spath):
        try:
            with open(spath) as f:
                json.load(f)
            report.status_json = "ok"
        except (OSError, json.JSONDecodeError):
            report.status_json = "corrupt"
            if not has_journal:
                report.problems.append(
                    "status.json is corrupt and no journal exists — the "
                    "experiment is not resumable"
                )
    elif not has_journal:
        report.problems.append("neither journal nor status.json present")
    return report
