"""PBT workload with REAL model state: a digits classifier whose weights,
momentum buffers and step counter ride the PBT checkpoint lineage (port of
``katib_tpu/models/pbt_digits.py``).

The toy workload (``pbt_toy.py``, reference ``simple-pbt`` parity) carries
one scalar through the lineage; this trial carries an actual model — exploit
clones the winner's checkpoint (parameters + momentum + step), explore
perturbs the learning rate, and training *continues* from the inherited
weights on the bundled REAL UCI digits (scikit-learn's; a caller without
scikit-learn puts a dataset of the same shape into :data:`_DATASET_CACHE`).

Trial params: ``lr`` (the evolved hyperparameter), ``steps_per_round``
(SGD minibatch steps per generation, default 60), ``batch`` (64).
Reports ``accuracy`` on the held-out split once per round.

The parameters keep the JAX layout (``w1`` is ``[d_in, hidden]``, the
logits ``relu(x @ w1 + b1) @ w2 + b2``), in float32 on the trial's device
(``cuda`` unless the caller names the CPU); ``convert.pbt_digits_params_from_jax``
carries JAX parameters across.  The weights are drawn from a
``torch.Generator`` seeded 0, as the JAX trial draws from ``PRNGKey(0)``:
the same shapes and scales, not the same numbers.  A checkpoint is the
flat ``{key path: tensor}`` snapshot of ``utils/checkpoint.py``:
``params/<name>``, ``velocity/<name>`` and ``step``, and from the
on-device twin also ``hypers/<name>`` and ``generation``, so a drained
on-device member resumes through either path.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from katib_tpu_torch.device import resolve_device
from katib_tpu_torch.models.data import Dataset, load_digits_real
from katib_tpu_torch.parallel.train import TrainState, stack_pytrees
from katib_tpu_torch.runner.cohort import attach_cohort_fn

_HIDDEN = 128
_NAMES = ("w1", "b1", "w2", "b2")

# a PBT sweep calls this trial dozens of times per process; reload and
# re-permute each round would be pure waste
_DATASET_CACHE: dict[tuple, Dataset] = {}
_DATASET_LOCK = threading.Lock()


def _cached_digits(n_train: int, n_test: int) -> Dataset:
    key = (n_train, n_test)
    with _DATASET_LOCK:
        if key not in _DATASET_CACHE:
            _DATASET_CACHE[key] = load_digits_real(n_train, n_test)
        return _DATASET_CACHE[key]


def _init_params(generator: torch.Generator, d_in: int, num_classes: int,
                 device=None) -> dict:
    """He-normal weights and zero biases (the JAX trial's scales), drawn on
    the CPU from ``generator`` and moved to ``device``."""
    s1 = (2.0 / d_in) ** 0.5
    s2 = (2.0 / _HIDDEN) ** 0.5
    params = {
        "w1": s1 * torch.randn(d_in, _HIDDEN, generator=generator),
        "b1": torch.zeros(_HIDDEN),
        "w2": s2 * torch.randn(_HIDDEN, num_classes, generator=generator),
        "b2": torch.zeros(num_classes),
    }
    return {k: v.to(device) for k, v in params.items()}


def _logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _loss(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(_logits(params, x), dim=-1)
    return -torch.gather(logp, 1, y.long()[:, None]).mean()


def _sgd_step(params: dict, velocity: dict, x, y, lr) -> tuple[dict, dict]:
    """One momentum-0.9 SGD step: ``v = 0.9 v + g``, ``p = p - lr v``."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    grads = dict(zip(leaves, torch.autograd.grad(_loss(leaves, x, y), list(leaves.values()))))
    velocity = {k: 0.9 * velocity[k] + grads[k] for k in params}
    return {k: params[k] - lr * velocity[k] for k in params}, velocity


def _accuracy(params: dict, x, y) -> torch.Tensor:
    with torch.no_grad():
        return (torch.argmax(_logits(params, x), dim=-1) == y).float().mean()


def _flat_state(params: dict, velocity: dict, step: int, device) -> dict:
    tree = {f"params/{k}": params[k] for k in _NAMES}
    tree.update({f"velocity/{k}": velocity[k] for k in _NAMES})
    tree["step"] = torch.tensor(step, dtype=torch.int32, device=device)
    return tree


def pbt_digits_trial(ctx) -> None:
    """The host trial: ``steps_per_round`` SGD steps from the (possibly
    inherited) checkpoint, then the test accuracy and a checkpoint."""
    dev = resolve_device(ctx.device)
    lr = float(ctx.params["lr"])
    steps_per_round = int(ctx.params.get("steps_per_round", 60))
    batch = int(ctx.params.get("batch", 64))

    ds = _cached_digits(1400, 397)
    x_train = ds.x_train.reshape(len(ds.x_train), -1)
    x_test = torch.from_numpy(ds.x_test.reshape(len(ds.x_test), -1)).to(dev)
    y_test = torch.from_numpy(ds.y_test).to(dev)

    restored = ctx.restore_checkpoint()
    if restored is not None:
        state, _ = restored
        params = {k: state[f"params/{k}"].to(dev) for k in _NAMES}
        velocity = {k: state[f"velocity/{k}"].to(dev) for k in _NAMES}
        start = int(state["step"]) + 1
    else:
        params = _init_params(torch.Generator().manual_seed(0), x_train.shape[1], 10, dev)
        velocity = {k: torch.zeros_like(v) for k, v in params.items()}
        start = 0

    rng = np.random.default_rng(start)  # advance the data stream per round
    step = start
    for step in range(start, start + steps_per_round):
        idx = rng.integers(0, len(x_train), size=batch)
        params, velocity = _sgd_step(params, velocity, torch.from_numpy(x_train[idx]).to(dev),
                                     torch.from_numpy(ds.y_train[idx]).to(dev), lr)

    acc = float(_accuracy(params, x_test, y_test))
    ctx.report(step=step, accuracy=acc)
    ctx.save_checkpoint(_flat_state(params, velocity, step, dev), step)


# -- on-device PBT twin -------------------------------------------------------


def member_loss(params: dict, batch) -> torch.Tensor:
    """One member's minibatch loss in the on-device generation."""
    return _loss(params, *batch)


def member_update(state: TrainState, grads: dict, hrow: dict) -> TrainState:
    """One member's update in the on-device generation (vmapped over the
    population): :func:`_sgd_step`'s at the member's ``lr``, the momentum
    trace as the optimizer state."""
    velocity = {k: 0.9 * state.opt_state[k] + grads[k] for k in state.params}
    params = {k: state.params[k] - hrow["lr"] * velocity[k] for k in state.params}
    return TrainState(state.step + 1, params, velocity)


def member_eval(state: TrainState, eval_batch) -> torch.Tensor:
    """One member's score: test accuracy (maximize)."""
    x, y = eval_batch
    return (torch.argmax(_logits(state.params, x), dim=-1) == y).float().mean()


def _member_checkpointers(cctx):
    from katib_tpu_torch.utils.checkpoint import TrialCheckpointer

    return [TrialCheckpointer(d) if d else None for d in cctx.checkpoint_dirs]


def pbt_digits_cohort(cctx) -> None:
    """The on-device PBT twin of :func:`pbt_digits_trial`: the whole
    population trains, scores, selects, clones and perturbs on the device
    (``parallel/pbt.py``), each generation's T train steps replaying one
    captured step, with host round-trips only at generation boundaries
    (scores/lineage fetch + the per-member checkpoints that make
    drain/resume lossless).

    Launched by the ``pbt-ondevice`` suggester, which stamps the shared
    ``pbt_*`` assignments (space JSON, generation count/length, truncation,
    resample probability, seed) on every member.  Without them (a plain
    cohort experiment over this trial fn) it raises, and ``run_cohort``
    falls back to serial per-member execution — the host path.

    Checkpoint schema stays a superset of the host trial's
    (``params``/``velocity``/``step`` + ``hypers``/``generation``), so a
    drained on-device member can resume through EITHER path.  Scores are
    test-set accuracy (maximize), matching the host trial's report.  The
    JAX twin's cost observation (``costmodel.observe_program``) waits for
    the cost layer (ROADMAP Queue 1 item 8b)."""
    from katib_tpu_torch.parallel.pbt import (
        decode_member_hypers,
        encode_hypers,
        generation_seed,
        make_pbt_generation_step,
        specs_from_json,
    )
    from katib_tpu_torch.suggest.pbt import GENERATION_LABEL, PARENT_LABEL
    from katib_tpu_torch.utils import observability as obs
    from katib_tpu_torch.utils import tracing

    space_json = cctx.shared("pbt_space", None)
    if space_json is None:
        raise ValueError(
            "pbt_digits_cohort needs the pbt-ondevice suggester's pbt_space "
            "assignment (plain cohorts fall back to the serial trial path)"
        )
    specs = specs_from_json(space_json)
    k = len(cctx)
    p = cctx.padded_size
    generations = int(cctx.shared("pbt_generations", 8))
    steps = int(cctx.shared("pbt_steps_per_generation", 60))
    truncation = float(cctx.shared("pbt_truncation", 0.25))
    resample_p = cctx.shared("pbt_resample_p", None)
    resample_p = float(resample_p) if resample_p is not None else None
    seed = int(cctx.shared("pbt_seed", 0))
    batch = int(cctx.shared("batch", 64))
    dev = resolve_device(cctx.device)

    ds = _cached_digits(1400, 397)
    data = cctx.place_shared((ds.x_train.reshape(len(ds.x_train), -1), ds.y_train))
    eval_batch = cctx.place_shared((ds.x_test.reshape(len(ds.x_test), -1), ds.y_test))
    n_train = len(ds.x_train)
    d_in = int(data[0].shape[1])

    # restore per-member state at a COMMON generation (drain saves every
    # member at the same boundary; a member missing that step restores its
    # newest earlier one and replays — the generation stream is a pure
    # function of (seed, g), so the replay is deterministic)
    ckptrs = _member_checkpointers(cctx)
    latest = [c.latest_step() if c is not None else None for c in ckptrs]
    start_gen = 0
    restore_at = None
    if all(s is not None for s in latest) and latest:
        restore_at = min(latest)
        start_gen = restore_at + 1

    member_states = []
    params_list = []
    for i in range(k):
        restored = None
        if restore_at is not None and ckptrs[i] is not None:
            steps_i = ckptrs[i].all_steps()
            at = restore_at if restore_at in steps_i else max(
                (s for s in steps_i if s <= restore_at), default=None)
            restored = ckptrs[i].restore(step=at) if at is not None else None
        if restored is not None:
            tree, _ = restored
            member_states.append(TrainState(
                tree["step"].to(dev, torch.int32),
                {n: tree[f"params/{n}"].to(dev) for n in _NAMES},
                {n: tree[f"velocity/{n}"].to(dev) for n in _NAMES},
            ))
            hyp = {n[len("hypers/"):]: v for n, v in tree.items() if n.startswith("hypers/")}
            if hyp:
                params_list.append(decode_member_hypers(
                    specs, {n: np.asarray([float(v)]) for n, v in hyp.items()}, 0))
            else:
                params_list.append(cctx.params_list[i])
        else:
            # identical init across members (host trial parity: seed 0)
            prm = _init_params(torch.Generator().manual_seed(0), d_in, 10, dev)
            member_states.append(TrainState(
                torch.zeros((), dtype=torch.int32, device=dev), prm,
                {n: torch.zeros_like(v) for n, v in prm.items()}))
            params_list.append(cctx.params_list[i])

    # ghost rows repeat member 0 (inert; never win, never cloned)
    member_states += [member_states[0]] * (p - k)
    gen_step = make_pbt_generation_step(
        member_loss, member_update, member_eval,
        states=cctx.place_members(stack_pytrees(member_states)),
        hypers=cctx.place_members(encode_hypers(specs, params_list, p)),
        data=data, eval_batch=eval_batch, steps=steps, batch_size=batch,
        specs=specs, k=k, truncation=truncation, resample_p=resample_p,
    )

    obs.pbt_onchip.set(1.0)
    try:
        for g in range(start_gen, generations):
            # per-generation streams are pure functions of (seed, g): a
            # same-seed rerun is bit-stable and a resumed run replays the
            # exact generation it drained out of
            idx = np.random.default_rng((seed, g)).integers(0, n_train, size=(steps, batch))
            generator = torch.Generator(device=dev).manual_seed(generation_seed(seed, g))
            started = time.perf_counter()
            scores, parent, exploited = gen_step(idx, generator)
            # generation boundary: the ONLY host transfers in the loop
            scores_np = scores.cpu().numpy()[:k].astype(float)
            parent_np = parent.cpu().numpy()[:k].astype(int)
            expl_np = exploited.cpu().numpy()[:k].astype(bool)
            n_exploits = int(expl_np.sum())
            n_winners = len(set(parent_np[expl_np]))
            obs.pbt_generations.inc()
            if n_exploits:
                obs.pbt_exploits.inc(float(n_exploits))
            tracing.record_span(
                "pbt-generation",
                time.perf_counter() - started,
                generation=g,
                exploits=n_exploits,
                winners=n_winners,
                perturbs=k - n_exploits,
                population=k,
                steps=steps,
            )
            # lineage, exactly as the host path labels next-gen trials:
            # exploiters point at their winner, explorers at themselves
            for i, t in enumerate(cctx.members):
                t.spec.labels[GENERATION_LABEL] = str(g + 1)
                t.spec.labels[PARENT_LABEL] = (
                    cctx.members[parent_np[i]].name if expl_np[i] else t.name
                )
            # an exploited member's row now carries its winner's state, so
            # report the score of what the member actually holds (a
            # diverged member heals through the exploit path instead of
            # settling Permanent-failed on a non-finite row)
            cont = cctx.report(
                step=g,
                accuracy=scores_np[parent_np],
                pbt_generation=np.full(k, float(g + 1)),
                pbt_parent=parent_np.astype(float),
                pbt_exploit=expl_np.astype(float),
            )
            # population checkpoint at the generation boundary: drain/resume
            # re-enters the loop at start_gen = g + 1 with zero lost
            # members.  The member saves overlap in a thread pool — each
            # commit is fsync/rename-bound
            host = {n: t.cpu() for n, t in _population_items(gen_step.states)}
            host_hypers = {n: h.cpu() for n, h in gen_step.hypers.items()}

            def _save_member(i: int) -> None:
                tree = {n: t[i] for n, t in host.items()}
                tree.update({f"hypers/{n}": h[i] for n, h in host_hypers.items()})
                tree["generation"] = torch.tensor(g, dtype=torch.int32)
                ckptrs[i].save(tree, g)

            with ThreadPoolExecutor(max_workers=min(8, k)) as pool:
                # list() re-raises the first member-save failure
                list(pool.map(_save_member, [i for i in range(k) if ckptrs[i] is not None]))
            if not cont or cctx.should_stop():
                return
    finally:
        obs.pbt_onchip.set(0.0)


def _population_items(states: TrainState) -> list[tuple[str, torch.Tensor]]:
    """The stacked population under the checkpoint's key paths."""
    items = [(f"params/{n}", states.params[n]) for n in _NAMES]
    items += [(f"velocity/{n}", states.opt_state[n]) for n in _NAMES]
    return items + [("step", states.step)]


attach_cohort_fn(pbt_digits_trial, pbt_digits_cohort)
