"""ENAS suggester: the stateful RL controller service (port of
``katib_tpu/nas/enas/service.py``).

Round 0 emits samples of the randomly initialised controller; every later
round takes the mean objective of the previous round's completed trials
(sign-flipped for minimize), trains the controller ``controller_train_steps``
REINFORCE steps, each on a freshly sampled arc with the round's reward, and
then samples the next round's architectures.  Each trial carries two string
parameters, ``architecture`` (per layer ``[op_id, skip...]``) and
``nn_config`` (network shape and op vocabulary), as in the JAX package.

The controller runs on the suggester's device: the orchestrator's (or a
suggestion service's), handed through ``make_suggester(spec, device=...)``;
a bare ``EnasSuggester(spec)`` resolves ``cuda`` and raises where there is
none.  On a CUDA device every operation of the suggester runs on a stream
it leases for its life (``nas/darts/step_loop.py::lease_stream``), and it
waits on that stream only, outside its two captures, which hold the
device's capture lock as every capture does: the capture rule of
``compile/prewarm.py``.  A suggestion service shared by several
experiments trains the controller while another experiment's trials
capture CUDA graphs on the same card; a device-wide sync outside the lock
could land inside their capture.

The controller's state (parameters, Adam state, baseline, step), the arc
and the reward live in fixed tensors.  On a CUDA device one REINFORCE step
on a fresh sample, and one sample, are each warmed up on copies, captured
once as a CUDA graph on the suggester's stream under the device's capture
lock (``step_loop.py::capture_step``) and replayed, the sampler's
generator registered with both graphs (the JAX package jits
``train_step`` and ``sample``); on the CPU the same two functions run
eagerly on the same buffers.  ``arc_to_json`` stays the one transfer to the
host.

``state_dict()`` holds the round, the trained rounds and the controller's
parameters, Adam state, baseline and step as CPU tensors, so a state
written on the card loads on a host without one; the random stream is not
in it, as in the JAX package.
A JAX package's ENAS pickle (its controller state holds optax and JAX
classes) is not read: ``load_state_dict`` raises on it, and the orchestrator
then rebuilds a fresh suggester from the journal, as for any unreadable
state.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import torch

from katib_tpu_torch.core.types import (
    Experiment,
    ExperimentSpec,
    ParameterAssignment,
    TrialAssignmentSet,
)
from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.models.mnist import AdamState
from katib_tpu_torch.nas.darts.step_loop import capture_step, lease_stream
from katib_tpu_torch.nas.enas.child import DEFAULT_OPERATIONS
from katib_tpu_torch.nas.enas.controller import (
    Arc,
    ControllerConfig,
    ControllerParams,
    ReinforceState,
    arc_to_json,
    make_reinforce,
)
from katib_tpu_torch.suggest.base import (
    Suggester,
    SuggesterError,
    SuggestionsNotReady,
    register,
)
from katib_tpu_torch.utils import tracing

ROUND_LABEL = "enas-round"

_SETTING_TYPES = {
    "controller_hidden_size": int,
    "controller_temperature": float,
    "controller_tanh_const": float,
    "controller_entropy_weight": float,
    "controller_baseline_decay": float,
    "controller_learning_rate": float,
    "controller_skip_target": float,
    "controller_skip_weight": float,
    "controller_train_steps": int,
}

# settings that accept the reference's "None" sentinel to disable the feature
# (``enas/AlgorithmSettings.py`` checkNumericAndNone list)
_NULLABLE_SETTINGS = {
    "controller_temperature",
    "controller_tanh_const",
    "controller_entropy_weight",
    "controller_skip_weight",
}


def _operations_from_nas_config(nas_config) -> list[str]:
    ops: list[str] = []
    for op in nas_config.operations:
        sizes = []
        for p in op.parameters:
            if p.name == "filter_size" and p.feasible.list:
                sizes = list(p.feasible.list)
        if sizes:
            ops.extend(f"{op.operation_type}_{k}x{k}" for k in sizes)
        else:
            ops.append(op.operation_type)
    return ops


def _to(tree, device):
    """Every tensor of a nested dict/list state moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.detach().to(device, copy=True)


def _leaves(state: ReinforceState) -> list[torch.Tensor]:
    """Every tensor of a controller state, in a fixed order."""
    opt = state.opt_state
    return [*state.params, *opt.hyperparams.values(), opt.count, *opt.mu.values(),
            *opt.nu.values(), state.baseline, state.step]


def _clone_state(state: ReinforceState) -> ReinforceState:
    opt = state.opt_state
    clone = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
    return ReinforceState(ControllerParams(*(t.clone() for t in state.params)),
                          AdamState(clone(opt.hyperparams), opt.count.clone(), clone(opt.mu),
                                    clone(opt.nu)),
                          state.baseline.clone(), state.step.clone())


@register("enas")
class EnasSuggester(Suggester):
    takes_device = True

    @classmethod
    def validate(cls, spec: ExperimentSpec) -> None:
        if spec.nas_config is None or not spec.nas_config.operations:
            raise SuggesterError("enas requires nas_config with operations")
        s = spec.algorithm.settings
        for name, caster in _SETTING_TYPES.items():
            if name not in s:
                continue
            if s[name] == "None":
                if name not in _NULLABLE_SETTINGS:
                    raise SuggesterError(f"{name} does not accept None")
                continue
            try:
                caster(s[name])
            except (TypeError, ValueError):
                raise SuggesterError(f"{name} must be {caster.__name__}") from None
        if "controller_baseline_decay" in s and not (
            0.0 <= float(s["controller_baseline_decay"]) <= 1.0
        ):
            raise SuggesterError("controller_baseline_decay must be in [0, 1]")

    def __init__(self, spec: ExperimentSpec, device: str | torch.device | None = None):
        super().__init__(spec)
        self.device = resolve_device(device)
        s = dict(spec.algorithm.settings)

        def get(name, default, caster):
            raw = s.get(name)
            if raw is None:
                return default
            if raw == "None":
                return None
            return caster(raw)

        self.operations = (
            _operations_from_nas_config(spec.nas_config)
            if spec.nas_config
            else list(DEFAULT_OPERATIONS)
        )
        self.num_layers = spec.nas_config.graph_config.num_layers if spec.nas_config else 8
        self.cfg = ControllerConfig(
            num_layers=self.num_layers,
            num_operations=len(self.operations),
            hidden_size=get("controller_hidden_size", 64, int),
            temperature=get("controller_temperature", 5.0, float),
            tanh_const=get("controller_tanh_const", 2.25, float),
            entropy_weight=get("controller_entropy_weight", 1e-5, float),
            baseline_decay=get("controller_baseline_decay", 0.999, float),
            learning_rate=get("controller_learning_rate", 5e-5, float),
            skip_target=get("controller_skip_target", 0.4, float),
            skip_weight=get("controller_skip_weight", 0.8, float),
        )
        self.train_steps = get("controller_train_steps", 50, int)
        self._lease = lease_stream(self.device) if self.device.type == "cuda" else None
        init, self._train_step, self._sample = make_reinforce(self.cfg, self.device)
        # the weights from the CPU (the same on every device), the samples
        # from a generator on the controller's device
        with self._own_stream():
            self.state = init(torch.Generator().manual_seed(self.seed()))
            n = self.num_layers
            self.arc = Arc(torch.zeros(n, dtype=torch.int64, device=self.device),
                           torch.zeros(n, n, dtype=torch.int64, device=self.device))
            self.reward = torch.zeros((), dtype=torch.float32, device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed(1))
        # replay the captured steps on a card (False runs them eagerly there,
        # the reference the smoke and the card tests hold the replays to)
        self.capture = self.device.type == "cuda"
        self._graphs: dict[str, torch.cuda.CUDAGraph] = {}
        self.round = 0
        self._trained_rounds: set[int] = set()

    @contextlib.contextmanager
    def _own_stream(self):
        """Run the body's device work on the suggester's own stream (a no-op
        off CUDA)."""
        if self._lease is None:
            yield
            return
        with torch.cuda.stream(self._lease.stream):
            yield

    # -- persistence hooks --------------------------------------------------

    def state_dict(self) -> dict:
        st = self.state
        with self._own_stream():
            controller = _to({
                "params": st.params._asdict(),
                "opt_state": st.opt_state._asdict(),
                "baseline": st.baseline,
                "step": st.step,
            }, "cpu")
        return {
            "round": self.round,
            "trained_rounds": sorted(self._trained_rounds),
            "controller": controller,
        }

    def load_state_dict(self, data: dict) -> None:
        ctrl = data["controller"]
        if not isinstance(ctrl, dict) or set(ctrl) != {"params", "opt_state", "baseline", "step"}:
            raise ValueError(
                f"not a katib_tpu_torch ENAS controller state ({type(ctrl).__name__}); "
                "a JAX package's state is not read by the port"
            )
        with self._own_stream():
            ctrl = _to(ctrl, self.device)
        state = ReinforceState(ControllerParams(**ctrl["params"]), AdamState(**ctrl["opt_state"]),
                               ctrl["baseline"], ctrl["step"])
        with self._own_stream():  # into the fixed tensors a graph reads
            torch._foreach_copy_(_leaves(self.state), _leaves(state))
        self.round = data["round"]
        self._trained_rounds = set(data["trained_rounds"])

    # -- main ---------------------------------------------------------------

    def _round_trials(self, experiment: Experiment, rnd: int):
        return [
            t
            for t in experiment.trials.values()
            if t.labels.get(ROUND_LABEL) == str(rnd)
        ]

    def _mean_reward(self, trials) -> float | None:
        """Reference ``GetEvaluationResult``: mean objective of the round's
        completed trials, sign-flipped for minimize."""
        obj = self.spec.objective
        sign = 1.0 if obj.type.value == "maximize" else -1.0
        vals = [
            t.objective_value(obj)
            for t in trials
            if t.condition.is_completed_ok() and t.objective_value(obj) is not None
        ]
        if not vals:
            return None
        return sign * float(np.mean(vals))

    def _sample_into(self, bufs) -> None:
        """Draw an arc from the generator into ``bufs``' arc."""
        state, arc, _ = bufs
        sampled, _ = self._sample(state.params, self._gen)
        arc.ops.copy_(sampled.ops)
        arc.skips.copy_(sampled.skips)

    def _reinforce(self, bufs) -> None:
        """One REINFORCE step on a fresh sample with ``bufs``' reward, its
        new state written back into ``bufs``."""
        self._sample_into(bufs)
        state, arc, reward = bufs
        new, _ = self._train_step(state, arc, reward)
        torch._foreach_copy_(_leaves(state), _leaves(new))

    def _run(self, name: str, fn) -> None:
        """``fn`` on the fixed tensors: its graph's replay on a CUDA device
        (captured at the first call), else ``fn`` itself."""
        bufs = (self.state, self.arc, self.reward)
        if not self.capture:
            fn(bufs)
            return
        if name not in self._graphs:
            stream = self._lease.stream if self._lease is not None else None
            self._graphs[name], _, _ = capture_step(
                fn, bufs, lambda b: (_clone_state(b[0]), Arc(b[1].ops.clone(), b[1].skips.clone()),
                                     b[2].clone()),
                self.device, stream=stream, generators=(self._gen,))
        self._graphs[name].replay()

    def train_controller(self, reward: float) -> None:
        """``controller_train_steps`` REINFORCE steps, each on a fresh
        sample, with ``reward``; returns once the device has finished them
        (a wait on the suggester's own stream, never the whole device)."""
        with self._own_stream():
            self.reward.fill_(reward)
            for _ in range(self.train_steps):
                self._run("reinforce", self._reinforce)
        if self._lease is not None:
            self._lease.stream.synchronize()

    def get_suggestions(
        self, experiment: Experiment, count: int
    ) -> list[TrialAssignmentSet]:
        prev = self._round_trials(experiment, self.round - 1) if self.round else []
        if prev:
            if any(not t.condition.is_terminal() for t in prev):
                raise SuggestionsNotReady(
                    f"enas round {self.round - 1} still has trials running"
                )
            if (self.round - 1) not in self._trained_rounds:
                reward = self._mean_reward(prev)
                if reward is not None:
                    with tracing.span(
                        "enas.controller_train",
                        round=self.round - 1,
                        steps=self.train_steps,
                    ):
                        self.train_controller(reward)
                self._trained_rounds.add(self.round - 1)

        nn_config = json.dumps(
            {
                "num_layers": self.num_layers,
                "operations": self.operations,
            }
        )
        out = []
        for _ in range(count):
            # the arc's transfer to the host waits on the suggester's stream
            with self._own_stream():
                self._run("sample", self._sample_into)
                architecture = json.dumps(arc_to_json(self.arc))
            out.append(
                TrialAssignmentSet(
                    assignments=[
                        ParameterAssignment("architecture", architecture),
                        ParameterAssignment("nn_config", nn_config),
                    ],
                    labels={ROUND_LABEL: str(self.round)},
                )
            )
        self.round += 1
        return out
