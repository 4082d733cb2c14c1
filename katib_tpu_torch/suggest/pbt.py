"""Population-Based Training: the host ``pbt`` suggester and
``pbt-ondevice``, which evolves the population as one vectorized cohort
(``parallel/pbt.py``).

Copy of ``katib_tpu/suggest/pbt.py``.  The journaled ``state_dict`` is the
JAX suggester's JSON, so either package resumes the other's run.

Capability parity with the reference's ``pbt`` service
(``pkg/suggestion/v1beta1/pbt/service.py``): a job queue seeded from the
search space, truncation selection per generation — the bottom quantile
*exploits* (restarts from a top-quantile member's checkpoint + hyperparams),
the rest *explore* (perturb x0.8/x1.2 or resample with
``resample_probability``) — failed/killed members re-queued with identical
parameters, and generation/parent lineage carried in trial labels.

Design changes vs the reference:
- Checkpoint lineage uses the trial runner's per-trial checkpoint directories
  under the experiment workdir (``torch.save`` steps for white-box trials,
  ``utils/checkpoint.py``) instead of a ReadWriteMany PVC mounted into pods;
  the exploit copy is still a directory copy (``pbt/service.py:259-268``) but
  initiated by the suggester in-process.
- The reference's exploit step copies the *loser's* checkpoint while taking
  the winner's hyperparameters (``service.py:383-389``: ``parent=job.uid`` for
  the below-threshold job).  Standard PBT — and this implementation — clones
  the winner's checkpoint AND hyperparameters, which is the behavior the PBT
  paper specifies and what actually transfers learned weights.
"""

from __future__ import annotations

import os
import shutil
import uuid

import numpy as np

from katib_tpu_torch.core.types import (
    COHORT_KEY_LABEL,
    Experiment,
    ExperimentSpec,
    ParameterAssignment,
    Trial,
    TrialAssignmentSet,
)
from katib_tpu_torch.suggest.base import Suggester, SuggesterError, register
from katib_tpu_torch.suggest.space import SpaceEncoder

GENERATION_LABEL = "pbt-generation"
PARENT_LABEL = "pbt-parent"

#: cohort key stamped on every pbt-ondevice member so the orchestrator
#: groups the whole population into ONE vectorized program
ONDEVICE_COHORT_KEY = "pbt-ondevice"


def resolve_pbt_ondevice(spec: ExperimentSpec) -> bool:
    """Whether ``pbt-ondevice`` actually evolves on device.  Escape-hatch
    precedence: ``KATIB_PBT_ONDEVICE`` env > ``spec.pbt_ondevice``
    (``pbtOnDevice`` YAML knob) > the ``on_device`` algorithm setting >
    default ON."""
    env = os.environ.get("KATIB_PBT_ONDEVICE")
    if env:
        return env.strip().lower() not in ("0", "false", "no", "off")
    if getattr(spec, "pbt_ondevice", None) is not None:
        return bool(spec.pbt_ondevice)
    raw = spec.algorithm.settings.get("on_device")
    if raw is not None:
        return str(raw).strip().lower() not in ("0", "false", "no", "off")
    return True

class _PbtJob:
    def __init__(self, uid: str, params: dict, generation: int, parent: str | None):
        self.uid = uid
        self.params = params
        self.generation = generation
        self.parent = parent
        self.score: float | None = None  # scaled so higher is better


@register("pbt")
class PbtSuggester(Suggester):
    """Stateful population manager (in-memory, like the reference service);
    completed-trial sync is idempotent so repeated calls are safe."""

    @classmethod
    def validate(cls, spec: ExperimentSpec) -> None:
        s = spec.algorithm.settings
        for key in ("n_population", "truncation_threshold"):
            if key not in s:
                raise SuggesterError(f"pbt requires setting {key}")
        if int(s["n_population"]) < 5:
            raise SuggesterError("n_population should be >= 5")
        if not 0.0 <= float(s["truncation_threshold"]) <= 0.5:
            raise SuggesterError("truncation_threshold should be in [0, 0.5]")
        if "resample_probability" in s and not 0.0 <= float(s["resample_probability"]) <= 1.0:
            raise SuggesterError("resample_probability should be in [0, 1]")

    def __init__(self, spec: ExperimentSpec):
        super().__init__(spec)
        s = spec.algorithm.settings
        self.population = int(s["n_population"])
        self.truncation = float(s["truncation_threshold"])
        self.resample_p = (
            float(s["resample_probability"]) if "resample_probability" in s else None
        )
        self.checkpoint_root = s.get(
            "suggestion_trial_dir", os.path.join("katib_runs", spec.name, "pbt")
        )
        self._rng = self.rng()
        self._space = SpaceEncoder(spec.parameters)
        self.pending: list[_PbtJob] = []
        self.running: dict[str, _PbtJob] = {}
        self.completed: dict[str, _PbtJob] = {}
        self.pool_current: list[str] = []
        self.pool_previous: list[str] = []
        self._seed_population(self.population)

    # -- perturbation (reference HyperParameterSampler.perturb) -------------

    def _perturb(self, name: str, value) -> object:
        p = self.spec.parameter(name)
        f = p.feasible
        if p.type.value in ("double", "int"):
            factor = float(self._rng.choice([0.8, 1.2]))
            v = float(value) * factor
            v = min(float(f.max), max(float(f.min), v))
            return p.cast(v)
        # discrete/categorical: step to a neighbor, wrapping at the end
        values = list(f.list)
        idx = values.index(p.cast(value)) + int(self._rng.choice([-1, 1]))
        return values[idx % len(values)]

    # -- queue management ---------------------------------------------------

    def _new_uid(self) -> str:
        return f"{self.spec.name}-{uuid.uuid4().hex[:8]}"

    def _ckpt_dir(self, uid: str) -> str:
        return os.path.join(self.checkpoint_root, uid)

    def _append(self, params: dict, generation: int, parent: str | None) -> _PbtJob:
        job = _PbtJob(self._new_uid(), dict(params), generation, parent)
        self.pending.append(job)
        new_dir = self._ckpt_dir(job.uid)
        if os.path.isdir(new_dir):
            shutil.rmtree(new_dir)
        if parent is None:
            os.makedirs(new_dir, exist_ok=True)
        else:
            parent_dir = self._ckpt_dir(parent)
            if os.path.isdir(parent_dir):
                shutil.copytree(parent_dir, new_dir)
            else:
                os.makedirs(new_dir, exist_ok=True)
        return job

    def _seed_population(self, count: int) -> None:
        for _ in range(count):
            self._append(self._space.sample(self._rng), generation=0, parent=None)

    def _sync(self, experiment: Experiment) -> None:
        """Fold newly-terminal trials into the population state."""
        obj = self.spec.objective
        sign = 1.0 if obj.type.value == "maximize" else -1.0
        for t in experiment.trials.values():
            if t.name not in self.running or not t.condition.is_terminal():
                continue
            job = self.running.pop(t.name)
            self.completed[job.uid] = job
            if t.condition.is_completed_ok():
                v = t.objective_value(obj)
                job.score = sign * v if v is not None else None
                if job.score is not None:
                    self.pool_current.append(job.uid)
            else:
                # retry failed/killed members with identical params+lineage
                # (reference ``pbt/service.py:303-322``)
                self._append(job.params, job.generation, job.parent)

    # -- generation logic ---------------------------------------------------

    def _segment(self, pool: list[str], count: int):
        jobs = [self.completed[uid] for uid in pool if self.completed[uid].score is not None]
        scores = np.array([j.score for j in jobs])
        lo, hi = np.quantile(scores, (self.truncation, 1.0 - self.truncation))
        exploit = [j for j in jobs if j.score < lo]
        explore = [j for j in jobs if j.score >= lo]
        upper = [j for j in jobs if j.score >= hi]
        self._rng.shuffle(exploit)
        self._rng.shuffle(explore)
        # round half-up with a floor of 1 whenever anyone actually fell
        # below the quantile: plain int() floors to 0 for
        # count < 1/truncation, silently turning PBT into random search
        # for small populations / partial refills
        n_exploit = int(count * self.truncation + 0.5)
        if n_exploit == 0 and exploit:
            n_exploit = 1
        exploit = exploit[:n_exploit]
        explore = explore[: count - len(exploit)]
        return exploit, explore, upper

    def _generate(self, min_count: int) -> None:
        # strict '<': the generation turns over as soon as a full population
        # has completed (the reference's '<=', ``pbt/service.py:355``, needs
        # population+1 completions before it rolls over)
        if len(self.pool_current) < self.population:
            if not self.pool_previous:
                self._seed_population(min_count)
                return
            exploit, explore, upper = self._segment(self.pool_previous, min_count)
        else:
            exploit, explore, upper = self._segment(self.pool_current, self.population)
            self.pool_previous = self.pool_current
            self.pool_current = []

        # exploit: clone a top-quantile winner (checkpoint + hyperparameters)
        for job in exploit:
            winner = upper[int(self._rng.integers(len(upper)))] if upper else job
            self._append(winner.params, job.generation + 1, parent=winner.uid)
        # explore: continue own checkpoint with perturbed/resampled params
        for job in explore:
            new_params = {}
            for p in self.spec.parameters:
                if self.resample_p is None:
                    new_params[p.name] = self._perturb(p.name, job.params[p.name])
                elif self._rng.random() < self.resample_p:
                    new_params[p.name] = self._space.sample(self._rng)[p.name]
                else:
                    new_params[p.name] = job.params[p.name]
            self._append(new_params, job.generation + 1, parent=job.uid)

    # -- Suggester API ------------------------------------------------------

    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        self._sync(experiment)
        while len(self.pending) < count:
            self._generate(count)
        out = []
        for _ in range(count):
            job = self.pending.pop(0)
            self.running[job.uid] = job
            labels = {GENERATION_LABEL: str(job.generation)}
            if job.parent is not None:
                labels[PARENT_LABEL] = job.parent
            out.append(
                TrialAssignmentSet(
                    name=job.uid,
                    assignments=[
                        ParameterAssignment(k, v) for k, v in job.params.items()
                    ],
                    labels=labels,
                )
            )
        return out

    def checkpoint_dir_for(self, trial_name: str) -> str:
        """The runner mounts this as the trial's checkpoint directory (parity
        with the webhook mounting the PBT PVC, ``inject_webhook.go:334-365``)."""
        return self._ckpt_dir(trial_name)

    # -- persistence hooks (orchestrator journals these across restarts;
    # the reference's PVC held only the checkpoints — its in-memory queue
    # was lost on service restart, an acknowledged gap) -----------------

    @staticmethod
    def _job_dict(job: _PbtJob) -> dict:
        return {
            "uid": job.uid,
            "params": dict(job.params),
            "generation": job.generation,
            "parent": job.parent,
            "score": job.score,
        }

    @staticmethod
    def _job_from(d: dict) -> _PbtJob:
        job = _PbtJob(d["uid"], dict(d["params"]), d["generation"], d["parent"])
        job.score = d["score"]
        return job

    def state_dict(self) -> dict:
        return {
            "rng": self._rng.bit_generator.state,
            "pending": [self._job_dict(j) for j in self.pending],
            "running": {k: self._job_dict(j) for k, j in self.running.items()},
            "completed": {k: self._job_dict(j) for k, j in self.completed.items()},
            "pool_current": list(self.pool_current),
            "pool_previous": list(self.pool_previous),
        }

    def load_state_dict(self, data: dict) -> None:
        # parse everything BEFORE mutating, so a schema mismatch leaves the
        # freshly-seeded suggester intact (the caller falls back to it)
        rng_state = data["rng"]
        pending = [self._job_from(d) for d in data["pending"]]
        running = {k: self._job_from(d) for k, d in data["running"].items()}
        completed = {k: self._job_from(d) for k, d in data["completed"].items()}
        pool_current = list(data["pool_current"])
        pool_previous = list(data["pool_previous"])
        # discard the freshly-seeded boot population (and its just-created
        # empty checkpoint dirs) in favor of the journaled queue
        for job in self.pending:
            shutil.rmtree(self._ckpt_dir(job.uid), ignore_errors=True)
        self._rng.bit_generator.state = rng_state
        self.pending = pending
        self.running = running
        self.completed = completed
        self.pool_current = pool_current
        self.pool_previous = pool_previous


@register("pbt-ondevice")
class PbtOnDeviceSuggester(PbtSuggester):
    """PBT whose generations run ON DEVICE: the whole population dispatches
    once as a single cohort and evolves there (``parallel/pbt.py``) —
    exploit is an ``index_select`` permutation over the stacked ``[K, ...]``
    member axis, explore a perturbation drawn on the device, and the host
    sees only generation-boundary summaries.

    Additional settings over ``pbt``: ``generations`` (evolution rounds per
    dispatch, default 8), ``steps_per_generation`` (train steps between
    selections, default 60), ``on_device`` ("false" falls back to the exact
    host ``PbtSuggester`` exchange — the escape hatch, also reachable via
    ``spec.pbt_ondevice`` / ``KATIB_PBT_ONDEVICE``).

    Requires a cohort-capable train_fn whose cohort twin understands the
    ``pbt_*`` shared assignments (e.g.
    ``katib_tpu_torch.models.pbt_digits.pbt_digits_trial``).  Lineage labels
    (generation, parent) are settled onto the member trials by the cohort
    fn at every generation boundary, and per-generation ``pbt_parent`` /
    ``pbt_exploit`` metric rows land in the ObservationStore, so journal
    and status see the same history the host exchange would produce.
    """

    @classmethod
    def validate(cls, spec: ExperimentSpec) -> None:
        super().validate(spec)
        s = spec.algorithm.settings
        for key in ("generations", "steps_per_generation"):
            if key in s and int(s[key]) < 1:
                raise SuggesterError(f"{key} must be >= 1")
        if resolve_pbt_ondevice(spec):
            pop = int(s["n_population"])
            if spec.max_trial_count is not None and spec.max_trial_count < pop:
                raise SuggesterError(
                    "pbt-ondevice dispatches the whole population as one "
                    f"cohort: max_trial_count ({spec.max_trial_count}) must "
                    f"be >= n_population ({pop})"
                )

    def __init__(self, spec: ExperimentSpec):
        super().__init__(spec)
        s = spec.algorithm.settings
        self.generations = int(s.get("generations", 8))
        self.steps_per_generation = int(s.get("steps_per_generation", 60))
        self.on_device = resolve_pbt_ondevice(spec)
        self._dispatched = False
        if self.on_device:
            # the population is ONE cohort: widen the orchestrator's
            # grouping window so it never splits the members
            spec.cohort_width = max(spec.cohort_width, self.population)

    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        if not self.on_device:
            # escape hatch: exact host checkpoint-exchange semantics
            return super().get_suggestions(experiment, count)
        self._sync(experiment)
        if self._dispatched:
            return []  # one dispatch per experiment -> exhausted
        self._dispatched = True
        from katib_tpu_torch.parallel.pbt import specs_from_parameters, specs_to_json

        space_json = specs_to_json(specs_from_parameters(self.spec.parameters))
        jobs = self.pending[: self.population]
        self.pending = self.pending[self.population :]
        out = []
        for slot, job in enumerate(jobs):
            self.running[job.uid] = job
            assignments = [
                ParameterAssignment(k, v) for k, v in job.params.items()
            ]
            # generation-step config rides as shared assignments: the
            # cohort fn reads them via cctx.shared() so the whole
            # population provably agrees on the program
            assignments += [
                ParameterAssignment("pbt_slot", slot),
                ParameterAssignment("pbt_population", self.population),
                ParameterAssignment("pbt_generations", self.generations),
                ParameterAssignment(
                    "pbt_steps_per_generation", self.steps_per_generation
                ),
                ParameterAssignment("pbt_truncation", self.truncation),
                ParameterAssignment("pbt_seed", int(self.seed() % (2**31))),
                ParameterAssignment("pbt_space", space_json),
            ]
            if self.resample_p is not None:
                assignments.append(
                    ParameterAssignment("pbt_resample_p", self.resample_p)
                )
            out.append(
                TrialAssignmentSet(
                    name=job.uid,
                    assignments=assignments,
                    labels={
                        GENERATION_LABEL: "0",
                        COHORT_KEY_LABEL: ONDEVICE_COHORT_KEY,
                    },
                )
            )
        return out

    def state_dict(self) -> dict:
        data = super().state_dict()
        data["dispatched"] = self._dispatched
        return data

    def load_state_dict(self, data: dict) -> None:
        super().load_state_dict(data)
        self._dispatched = bool(data.get("dispatched", False))
