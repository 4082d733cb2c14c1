"""Trial checkpointing: ``torch.save`` snapshots with step retention (port
of ``katib_tpu/utils/checkpoint.py``).

Layout under a trial's checkpoint directory, the JAX package's::

    <dir>/step_00000010/state.pt          # one snapshot per step
    <dir>/step_00000010.manifest.json     # sidecar: format, file sizes, digest
    <dir>/quarantine-step_00000012/       # a step restore() refused

A snapshot is a flat ``{key path: tensor}`` dict saved from the CPU (the
search state's :func:`~katib_tpu_torch.nas.darts.architect.state_items`).
Its sidecar manifest, written durably after the step directory is in
place, names the format (``"format": "torch"``), each file's size and a
structure digest over the key paths, shapes and dtypes.  ``restore()``
quarantines a step whose files are missing or resized, whose digest differs
from the template's, or that fails to load, and falls back to the newest
step that verifies.

A step written by the JAX package (Orbax files, or a manifest without the
torch format) is not read: ``restore()`` raises ``NotImplementedError``
naming it, and neither quarantines it nor starts afresh over it.  The
fallback counter gauge of the JAX package is not ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import torch

from katib_tpu_torch.utils.fsio import atomic_replace

FORMAT = "torch"
STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"^step_(\d{8})$")
_MANIFEST_SUFFIX = ".manifest.json"
_QUARANTINE_PREFIX = "quarantine-"


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _manifest_path(directory: str, step: int) -> str:
    return _step_path(directory, step) + _MANIFEST_SUFFIX


def tree_digest(tree: dict) -> str:
    """Structure digest of a ``{key path: tensor}`` snapshot: key paths,
    shapes and dtypes, hashed; reads no tensor data."""
    parts = [FORMAT] + [f"{k}:{tuple(t.shape)}:{t.dtype}" for k, t in tree.items()]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _walk_sizes(step_dir: str) -> dict[str, int]:
    sizes: dict[str, int] = {}
    for root, _, files in os.walk(step_dir):
        for fname in files:
            full = os.path.join(root, fname)
            try:
                sizes[os.path.relpath(full, step_dir)] = os.path.getsize(full)
            except OSError:
                sizes[os.path.relpath(full, step_dir)] = -1
    return sizes


class TrialCheckpointer:
    """Save and restore snapshots under one trial's checkpoint directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if not directory:
            raise ValueError("checkpoint directory is required")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    # -- queries -------------------------------------------------------------

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_DIR.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int) -> dict | None:
        try:
            with open(_manifest_path(self.directory, step)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def verify_step(self, step: int) -> bool | None:
        """Check a step against its manifest: True = verified, False =
        provably damaged (missing or resized files, step mismatch), None =
        no manifest to check against."""
        step_dir = _step_path(self.directory, step)
        if not os.path.isdir(step_dir):
            return False
        manifest = self._manifest(step)
        if manifest is None:
            return None
        if manifest.get("step") != step:
            return False
        for rel, size in (manifest.get("files") or {}).items():
            try:
                if os.path.getsize(os.path.join(step_dir, rel)) != size:
                    return False
            except OSError:
                return False
        return True

    def _reject_jax_step(self, step: int) -> None:
        """Raise for a step the JAX package wrote (Orbax), before anything
        could quarantine it."""
        step_dir = _step_path(self.directory, step)
        manifest = self._manifest(step)
        if manifest is not None:
            jax_written = manifest.get("format") != FORMAT
        else:
            entries = os.listdir(step_dir) if os.path.isdir(step_dir) else []
            jax_written = bool(entries) and STATE_FILE not in entries
        if jax_written:
            raise NotImplementedError(
                f"{step_dir} is a JAX checkpoint (written by katib_tpu through Orbax); "
                "the port reads only its own torch snapshots and will not resume from it "
                "or start afresh over it"
            )

    def quarantine_step(self, step: int, reason: str = "") -> None:
        """Move a damaged step (and its manifest) aside; ``all_steps()`` no
        longer sees it.  An unmovable dir is deleted instead."""
        step_dir = _step_path(self.directory, step)
        target = os.path.join(self.directory, f"{_QUARANTINE_PREFIX}step_{step:08d}")
        suffix = 0
        while os.path.exists(target):
            suffix += 1
            target = os.path.join(self.directory,
                                  f"{_QUARANTINE_PREFIX}step_{step:08d}.{suffix}")
        try:
            os.rename(step_dir, target)
            if reason:
                with open(os.path.join(target, "QUARANTINE_REASON"), "w") as f:
                    f.write(reason + "\n")
        except OSError:
            shutil.rmtree(step_dir, ignore_errors=True)
        try:
            os.replace(_manifest_path(self.directory, step), target + _MANIFEST_SUFFIX)
        except OSError:
            pass

    # -- save / restore ------------------------------------------------------

    def save(self, tree: dict, step: int, *, force: bool = True) -> str:
        """Write ``tree`` (``{key path: tensor}``, any device) as the snapshot
        of ``step`` and its manifest; prune steps beyond ``max_to_keep``.
        Returns the step's path."""
        os.makedirs(self.directory, exist_ok=True)
        path = _step_path(self.directory, step)
        if os.path.exists(path):
            if not force:
                raise FileExistsError(path)
            shutil.rmtree(path)
        cpu = {k: t.detach().cpu() for k, t in tree.items()}
        # the step dir appears whole or not at all
        tmp = f"{path}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(cpu, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        doc = {"format": FORMAT, "step": step, "tree_digest": tree_digest(cpu),
               "files": _walk_sizes(path)}
        atomic_replace(_manifest_path(self.directory, step), json.dumps(doc).encode(),
                       prefix=".manifest-", crash_site="checkpoint.manifest")
        if self.max_to_keep is not None and self.max_to_keep > 0:
            for old in self.all_steps()[: -self.max_to_keep]:
                shutil.rmtree(_step_path(self.directory, old), ignore_errors=True)
                try:
                    os.unlink(_manifest_path(self.directory, old))
                except OSError:
                    pass
        return path

    def restore(self, template: dict | None = None, step: int | None = None):
        """``(tree, step)`` of the newest step that verifies (or of ``step``),
        tensors on the CPU; ``None`` when none restores (a cold start).

        Candidates go newest first.  A step that fails its manifest, whose
        digest differs from ``template``'s, whose file fails to load or
        whose contents differ from ``template`` in keys, shapes or dtypes
        is quarantined and the next older step is tried.  A JAX-written
        step raises ``NotImplementedError``."""
        candidates = [step] if step is not None else list(reversed(self.all_steps()))
        for cand in candidates:
            if not os.path.isdir(_step_path(self.directory, cand)):
                continue
            self._reject_jax_step(cand)
            if self.verify_step(cand) is False:
                self.quarantine_step(cand, "manifest verification failed")
                continue
            manifest = self._manifest(cand)
            if (template is not None and manifest is not None
                    and manifest.get("tree_digest") != tree_digest(template)):
                self.quarantine_step(cand, "structure digest differs from the template's")
                continue
            try:
                tree = torch.load(os.path.join(_step_path(self.directory, cand), STATE_FILE),
                                  map_location="cpu", weights_only=True)
                if template is not None and tree_digest(tree) != tree_digest(template):
                    raise ValueError("contents differ from the template in keys, shapes or dtypes")
            except Exception as e:  # a torn or foreign file: quarantine, try older
                self.quarantine_step(cand, f"restore raised {type(e).__name__}: {e}")
                continue
            return tree, cand
        return None


def copy_checkpoint_tree(src_dir: str, dst_dir: str) -> bool:
    """Clone a trial's whole checkpoint directory (PBT exploit).  Returns
    False when ``src_dir`` does not exist.  The copy lands in a ``.tmp``
    sibling and is renamed into place only when complete."""
    if not os.path.isdir(src_dir):
        return False
    tmp_dir = dst_dir.rstrip("/\\") + ".tmp"
    if os.path.isdir(tmp_dir):
        shutil.rmtree(tmp_dir)
    shutil.copytree(src_dir, tmp_dir)
    if os.path.isdir(dst_dir):
        shutil.rmtree(dst_dir)
    os.rename(tmp_dir, dst_dir)
    return True
