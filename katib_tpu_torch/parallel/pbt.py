"""On-device Population Based Training: exploit/explore as a permutation of
the member axis (port of ``katib_tpu/parallel/pbt.py``).

The host ``pbt`` suggester (``suggest/pbt.py``) moves checkpoints between
trials with one save and one directory copy per member per generation.  A
cohort already holds the whole population as ONE stacked ``[K, ...]`` state
on the device, so a full PBT generation — train T steps, score,
truncation-select, clone winners, perturb hyperparameters — runs there,
with host transfers only at the generation boundary: "checkpoint exchange"
becomes ``index_select`` over the member axis, and hyperparameter
perturbation draws from an explicit device ``torch.Generator``.

Selection semantics mirror ``PbtSuggester`` (host reference):

- scores are scaled so higher is better; ``lo, hi`` are the
  ``(truncation, 1 - truncation)`` quantiles by linear interpolation,
  computed as ``jnp.quantile`` computes them in float32;
- the bottom quantile *exploits*: ``n_exploit = round_half_up(K * trunc)``
  members with score < lo (floored to 1 whenever anyone is below the
  quantile — the host's small-population floor fix), worst first by a
  stable sort, each clone a uniformly random winner (score >= hi): state
  AND hyperparameters;
- everyone else *explores*: each hyperparameter is perturbed x0.8/x1.2
  (clipped to bounds, rounded for ints, neighbor-stepped mod N for
  categorical/discrete) — or, with ``resample_probability`` set, is
  independently resampled from the prior with probability p and kept
  as-is otherwise, exactly the host ``_generate`` branch;
- ghost rows (shape buckets, rows ``[k:]``) never win, never exploit, and
  keep their hyperparameters;
- a member whose eval score goes non-finite ranks at the bottom and is
  overwritten by a winner on the next selection — divergence self-heals
  through the exploit path instead of freezing a row.

The draws are not JAX's (threefry cannot be reproduced): every random input
of a selection is one tensor of :class:`SelectionDraws`, made by
:func:`selection_draws` from a device generator, so that a test can pass in
the draws JAX's ``exploit_explore`` makes from its key and hold the rest of
the selection to JAX's exactly.

Hyperparameters live as a ``{name: [P] float32}`` dict (categorical/discrete
carried in index space); the encode/decode helpers translate to/from native
parameter dicts at generation boundaries only.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

# stands in for -inf so quantile interpolation over a pool containing a
# diverged member stays finite (x * inf = nan would poison the cut points)
_NEG = -1e30


def _round_half_up(x: float) -> int:
    return int(math.floor(x + 0.5))


# -- search-space description (host <-> device boundary) ----------------------


@dataclass(frozen=True)
class HyperSpec:
    """Device-side view of one parameter: enough to perturb/resample it on
    the device and decode it back to a native value at the boundary.
    ``kind`` is the ParameterType value; categorical/discrete carry their
    value list for index-space decode."""

    name: str
    kind: str  # "double" | "int" | "discrete" | "categorical"
    lo: float = 0.0
    hi: float = 1.0
    log: bool = False
    values: tuple = ()

    @property
    def categorical(self) -> bool:
        return self.kind in ("discrete", "categorical")

    @property
    def n_choices(self) -> int:
        return len(self.values)


def specs_from_parameters(parameters: Sequence[Any]) -> tuple[HyperSpec, ...]:
    """Build the device-side space description from ``ParameterSpec``s."""
    out = []
    for p in parameters:
        kind = p.type.value
        f = p.feasible
        if kind in ("double", "int"):
            out.append(HyperSpec(name=p.name, kind=kind, lo=float(f.min), hi=float(f.max),
                                 log=bool(f.is_log_scaled())))
        else:
            out.append(HyperSpec(name=p.name, kind=kind, values=tuple(f.list or ())))
    return tuple(out)


def specs_to_json(specs: Sequence[HyperSpec]) -> str:
    return json.dumps([
        {"name": s.name, "kind": s.kind, "lo": s.lo, "hi": s.hi, "log": s.log,
         "values": list(s.values)}
        for s in specs
    ])


def specs_from_json(payload: str) -> tuple[HyperSpec, ...]:
    return tuple(
        HyperSpec(name=d["name"], kind=d["kind"], lo=float(d.get("lo", 0.0)),
                  hi=float(d.get("hi", 1.0)), log=bool(d.get("log", False)),
                  values=tuple(d.get("values", ())))
        for d in json.loads(payload)
    )


def encode_hypers(specs: Sequence[HyperSpec], params_list: Sequence[Mapping[str, Any]],
                  padded_size: int | None = None, device=None) -> dict[str, torch.Tensor]:
    """Member parameter dicts -> ``{name: [P] float32}`` tensors on
    ``device`` (the CPU by default).  Categorical/discrete values are
    carried as their list index.  Ghost rows (``padded_size >
    len(params_list)``) repeat member 0."""
    k = len(params_list)
    p = padded_size if padded_size is not None else k
    out: dict[str, torch.Tensor] = {}
    for s in specs:
        vals = []
        for i in range(p):
            # ghost rows repeat member 0 (inert but finite — same
            # convention as CohortContext.stacked)
            v = params_list[i if i < k else 0][s.name]
            if s.categorical:
                try:
                    vals.append(float(list(s.values).index(_cat_cast(s, v))))
                except ValueError:
                    vals.append(0.0)
            else:
                vals.append(float(v))
        out[s.name] = torch.tensor(vals, dtype=torch.float32, device=device)
    return out


def _cat_cast(s: HyperSpec, v: Any):
    """Match a raw value against the spec's value list the way
    ``ParameterSpec.cast`` does for discrete (numeric tolerance)."""
    if s.kind == "discrete":
        fv = float(v)
        for item in s.values:
            if math.isclose(float(item), fv, rel_tol=1e-12, abs_tol=1e-12):
                return item
        return v
    return v


def decode_member_hypers(specs: Sequence[HyperSpec], hypers: Mapping[str, Any],
                         i: int) -> dict[str, Any]:
    """Row ``i`` of the hyper arrays (tensors or numpy) -> a native
    parameter dict."""
    out: dict[str, Any] = {}
    for s in specs:
        v = float(hypers[s.name][i])
        if s.categorical:
            out[s.name] = s.values[int(round(v)) % max(1, s.n_choices)]
        elif s.kind == "int":
            out[s.name] = int(round(v))
        else:
            out[s.name] = v
    return out


# -- the selection ------------------------------------------------------------


class SelectionDraws(NamedTuple):
    """Every random input of one :func:`exploit_explore`, each ``[P]``:

    - ``pick``: a uniform in [0, 1) per row; an exploiter clones the
      ``floor(pick * n_winners)``-th winner in member order;
    - ``flip``: ``{name: bool}``, perturb by x0.8 (True) or x1.2, or step
      the index by -1 (True) or +1;
    - ``take``: ``{name: bool}``, resample mode: draw from the prior;
    - ``u``: ``{name: float}``, resample mode: the prior draw's uniform."""

    pick: torch.Tensor
    flip: dict
    take: dict
    u: dict


def selection_draws(generator: torch.Generator, p: int, specs: Sequence[HyperSpec],
                    resample_p: float | None = None) -> SelectionDraws:
    """The draws of one selection over ``p`` rows from ``generator`` (on
    its device), in a fixed order: the pick, then per spec the flip or the
    take and the prior uniform."""
    dev = generator.device

    def rand():
        return torch.rand(p, generator=generator, device=dev)

    pick = rand()
    flip, take, u = {}, {}, {}
    for spec in specs:
        if resample_p is None:
            flip[spec.name] = rand() < 0.5
        else:
            take[spec.name] = rand() < resample_p
            u[spec.name] = rand()
    return SelectionDraws(pick, flip, take, u)


def _quantile(sorted_pool: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile of an ascending float32 pool, as
    ``jnp.quantile`` computes it: position ``q * (n - 1)`` and the weights
    in float32, then ``low * (1 - w) + high * w`` with the high term fused
    onto the rounded low term in one multiply-add (XLA's fusion; the
    float64 sum of a float32 and the exact product of two float32s rounds
    once to float32, as the fused operation does)."""
    n = sorted_pool.shape[0]
    pos = np.float32(q) * np.float32(n - 1)
    low = np.floor(pos)
    w_high = np.float32(pos - low)
    w_low = np.float32(1.0) - w_high
    lo_i = int(min(max(low, 0), n - 1))
    hi_i = int(min(max(np.ceil(pos), 0), n - 1))
    low_term = sorted_pool[lo_i] * float(w_low)
    return (low_term.double() + sorted_pool[hi_i].double() * float(w_high)).float()


def exploit_explore(scores: torch.Tensor, hypers: Mapping[str, torch.Tensor], draws: SelectionDraws,
                    *, specs: Sequence[HyperSpec], k: int, truncation: float,
                    resample_p: float | None = None):
    """One truncation-selection + perturbation step, on the scores' device
    with no host read.

    ``scores``: ``[P]`` float32 (higher is better; rows ``[k:]`` are
    ghosts).  ``hypers``: ``{name: [P]}`` (categorical in index space).
    ``draws``: :class:`SelectionDraws` over the same ``P`` rows.

    Returns ``(parent, new_hypers, exploited, stats)``: ``parent[i]`` is the
    member whose state row ``i`` should take (``i`` itself for explorers
    and ghosts) — apply with ``x.index_select(0, parent)`` on every state
    tensor; ``exploited`` is the ``[P]`` bool exploit mask; ``stats``
    carries the quantile cut points, ``n_exploit`` and the winner mask."""
    p = scores.shape[0]
    if not 0 < k <= p:
        raise ValueError(f"k={k} out of range for padded size {p}")
    dev = scores.device
    self_idx = torch.arange(p, device=dev)
    valid = self_idx < k
    finite = torch.isfinite(scores)
    s = torch.where(valid & finite, scores, torch.full_like(scores, _NEG))

    # cut points over the k REAL members (the slice excludes ghosts)
    pool = torch.sort(s[:k]).values
    lo = _quantile(pool, truncation)
    hi = _quantile(pool, 1.0 - truncation)

    below = valid & (s < lo)
    # host parity incl. the small-population fix: round half-up, floor of 1
    # whenever anyone actually fell below the quantile
    n_exploit = _round_half_up(k * truncation)
    n_exploit_dyn = torch.where(
        below.any(),
        torch.tensor(max(n_exploit, 1), dtype=torch.int32, device=dev),
        torch.tensor(n_exploit, dtype=torch.int32, device=dev),
    )
    # rank ascending among valid members (ghosts pushed past the end) so
    # "the n_exploit members below lo" is deterministic: worst first, ties
    # in member order (a stable sort, as jnp.argsort is)
    rank_key = torch.where(valid, s, torch.full_like(s, math.inf))
    order = torch.argsort(rank_key, stable=True)
    rank = torch.argsort(order, stable=True)
    exploited = below & (rank < n_exploit_dyn)

    winners = valid & finite & (s >= hi)
    exploited = exploited & winners.any()

    # the pick-th winner in member order (winners first, by a stable sort)
    n_win = winners.sum()
    winner_idx = torch.argsort((~winners).to(torch.int8), stable=True)
    nth = torch.minimum((draws.pick * n_win).long(), torch.clamp(n_win - 1, min=0))
    choice = winner_idx[nth]
    parent = torch.where(exploited, choice, self_idx)

    explore = valid & ~exploited
    new_hypers: dict[str, torch.Tensor] = {}
    for spec in specs:
        v = hypers[spec.name]
        if resample_p is None:
            # perturb: x0.8 / x1.2 clipped (linear, like the host _perturb),
            # or +-1 neighbor step mod N in index space
            flip = draws.flip[spec.name]
            if spec.categorical:
                step = torch.where(flip, -1.0, 1.0)
                perturbed = torch.remainder(torch.round(v) + step, float(max(1, spec.n_choices)))
            else:
                factor = torch.where(flip, 0.8, 1.2)
                perturbed = torch.clamp(v * factor, spec.lo, spec.hi)
                if spec.kind == "int":
                    perturbed = torch.round(perturbed)
        else:
            # resample-with-probability-p: fresh prior draw or keep AS-IS
            # (the host branch never perturbs in this mode)
            u = draws.u[spec.name]
            if spec.categorical:
                drawn = torch.clamp(torch.floor(u * spec.n_choices), 0, max(0, spec.n_choices - 1))
            elif spec.log:
                drawn = torch.exp(math.log(spec.lo)
                                  + u * (math.log(spec.hi) - math.log(spec.lo)))
            else:
                drawn = spec.lo + u * (spec.hi - spec.lo)
            if spec.kind == "int":
                drawn = torch.round(drawn)
            perturbed = torch.where(draws.take[spec.name], drawn, v)
        # exploiters inherit the winner's hyperparameters VERBATIM
        # (pre-perturb — standard PBT and the host's exploit branch)
        new_hypers[spec.name] = torch.where(
            exploited, v[parent], torch.where(explore, perturbed, v)).to(v.dtype)

    stats = {"lo": lo, "hi": hi, "n_exploit": n_exploit_dyn, "winners": winners}
    return parent, new_hypers, exploited, stats


# -- the generation step ------------------------------------------------------


class PbtGenerationStep:
    """The fused generation: T train steps, the eval, the selection, the
    clone and the perturbation of a stacked population held on the device
    (``katib_tpu``'s ``make_pbt_generation_step``, one jitted program with
    the population donated).

    The population lives in fixed tensors: :attr:`states` (a stacked
    ``[P, ...]`` ``TrainState``) and
    :attr:`hypers` (``{name: [P]}``).  The T train steps run in an
    ``EpochLoop`` (``models/mnist.py``): the minibatch indices of the
    generation fill a fixed ``[T, batch]`` buffer, each step gathers its
    minibatch from the resident ``data`` on the device, and on a CUDA
    device each step is one replay of a single captured graph (warmed up on
    copies, captured on the thread's stream under the device's lock); on
    the CPU the same step runs eagerly.  The eval, the selection and the
    clone run eagerly on the device, and the clone and the new
    hyperparameters are written back into the fixed tensors, which the
    captured step reads."""

    def __init__(self, member_loss: Callable, member_update: Callable, member_eval_fn: Callable,
                 *, states, hypers: dict, data: tuple, eval_batch, steps: int, batch_size: int,
                 specs: Sequence[HyperSpec], k: int, truncation: float,
                 resample_p: float | None = None, capture: bool | None = None):
        from katib_tpu_torch.models.mnist import EpochLoop

        self.specs, self.k, self.truncation, self.resample_p = tuple(specs), k, truncation, resample_p
        self.eval_batch = eval_batch
        self.hypers = {n: h.clone() for n, h in hypers.items()}
        losses_of = torch.func.vmap(member_loss, in_dims=(0, None))
        vupdate = torch.func.vmap(member_update, in_dims=(0, 0, 0))
        self._veval = torch.func.vmap(member_eval_fn, in_dims=(0, None))
        p = next(iter(self.hypers.values())).shape[0]

        def step(st, batch):
            params = {n: v.detach().requires_grad_() for n, v in st.params.items()}
            loss = losses_of(params, batch)
            grads = dict(zip(params, torch.autograd.grad(loss.sum(), list(params.values()))))
            return vupdate(st, grads, self.hypers), {"loss": loss.detach()}

        self.loop = EpochLoop(step, states, data[0], data[1], steps, batch_size,
                              capture=capture, loss_shape=(p,))

    @property
    def states(self):
        """The population's stacked state (the loop's fixed tensors)."""
        return self.loop.state

    def __call__(self, batch_idx: np.ndarray, generator: torch.Generator):
        """One generation over the ``[T, batch]`` minibatch indices
        ``batch_idx``, drawing the selection from ``generator`` (on the
        population's device).  Returns ``(scores, parent, exploited)``, each
        ``[P]`` on the device: the scores of the trained population before
        the selection, and the selection's outcome, already applied to
        :attr:`states` and :attr:`hypers`."""
        self.loop.run_epoch(batch_idx)
        with torch.no_grad():
            scores = self._veval(self.states, self.eval_batch).float()
        p = scores.shape[0]
        draws = selection_draws(generator, p, self.specs, self.resample_p)
        parent, new_hypers, exploited, _ = exploit_explore(
            scores, self.hypers, draws, specs=self.specs, k=self.k,
            truncation=self.truncation, resample_p=self.resample_p)
        cloned = tree_map(lambda x: x.index_select(0, parent), self.states)
        for dst, src in zip(tree_flatten(self.states)[0], tree_flatten(cloned)[0], strict=True):
            dst.copy_(src)
        for name, h in new_hypers.items():
            self.hypers[name].copy_(h)
        return scores, parent, exploited


def make_pbt_generation_step(member_loss: Callable, member_update: Callable,
                             member_eval_fn: Callable, *, states, hypers: dict, data: tuple,
                             eval_batch, steps: int, batch_size: int,
                             specs: Sequence[HyperSpec], k: int, truncation: float,
                             resample_p: float | None = None,
                             capture: bool | None = None) -> PbtGenerationStep:
    """Build the fused generation step over a population on the device.

    One member's SGD step (the JAX package's ``member_train_step``) comes
    in two parts: ``member_loss(params, batch) -> scalar`` on an ``(x, y)``
    minibatch, and ``member_update(state, grads, hypers_row) -> state``
    (``hypers_row`` is ``{name: scalar}``).  The losses are vmapped over the
    member axis and one backward pass of their sum gives every member its
    own gradient (as ``parallel/train.py::make_cohort_train_step`` does, so
    no functional-gradient transform runs); the update is vmapped over
    ``states``, the gradients and ``hypers``.  ``member_eval_fn(state,
    eval_batch) -> scalar`` scores one member (higher is better; apply the
    objective sign before), vmapped too.  ``states`` is a stacked
    ``TrainState``, ``data`` the resident ``(x, y)`` train split, ``steps``
    and ``batch_size`` the generation's ``[T, batch]``; ``capture`` as in
    ``EpochLoop`` (a CUDA graph on a CUDA device).  The population is copied
    into the step's fixed tensors; see :class:`PbtGenerationStep`."""
    return PbtGenerationStep(member_loss, member_update, member_eval_fn, states=states,
                             hypers=hypers, data=data, eval_batch=eval_batch, steps=steps,
                             batch_size=batch_size, specs=specs, k=k, truncation=truncation,
                             resample_p=resample_p, capture=capture)


def generation_seed(seed: int, generation: int) -> int:
    """The seed of generation ``generation``'s selection generator: a pure
    function of ``(seed, generation)``, so a same-seed rerun draws the same
    and a resumed run replays the generation it drained out of."""
    return int(np.random.SeedSequence((seed, generation)).generate_state(1)[0])
