"""The port's on-device Population Based Training (``parallel/pbt.py``,
``models/pbt_digits.py``, the ``pbt-ondevice`` suggester) against
``tests/test_pbt_ondevice.py``.

Against the JAX package, on the CPU: ``exploit_explore`` equals JAX's on the
same scores and the same draws — the draws JAX makes from its key
(``jax.random.split``/``fold_in`` as ``exploit_explore`` makes them) passed
in as the port's :class:`SelectionDraws` — exactly, but for a log-uniform
resample's ``exp``, within one float32 rounding; the generation's train
part equals JAX's within float32 tolerance from the same weights (carried
by ``convert.py``).  The port's own invariants: perturb factors within one
float32 rounding of x0.8/x1.2, ghost rows, the space JSON round trip, the
suggester's single dispatch, state round trip, escape hatch and env
switch, lineage through the orchestrator, a lossless drain and resume, and
a same-seed rerun bit-equal to itself.  The card's checks are in
``tests/test_torch_cohort_cuda.py``."""

from __future__ import annotations

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katib_tpu.models import pbt_digits as jdigits
from katib_tpu.parallel import pbt as jpbt
from katib_tpu_torch.convert import pbt_digits_params_from_jax, pbt_digits_state_from_jax
from katib_tpu_torch.core.types import (
    COHORT_KEY_LABEL,
    AlgorithmSpec,
    Experiment,
    ExperimentSpec,
    FeasibleSpace,
    ObjectiveSpec,
    ObjectiveType,
    ParameterSpec,
    ParameterType,
    Trial,
    TrialCondition,
    TrialSpec,
)
from katib_tpu_torch.models import pbt_digits as tdigits
from katib_tpu_torch.parallel import pbt as tpbt
from katib_tpu_torch.parallel.train import TrainState
from katib_tpu_torch.runner.cohort import run_cohort
from katib_tpu_torch.runner.context import TrialContext
from katib_tpu_torch.store.base import MemoryObservationStore
from katib_tpu_torch.suggest.base import SuggesterError, make_suggester
from katib_tpu_torch.suggest.pbt import (
    GENERATION_LABEL,
    ONDEVICE_COHORT_KEY,
    PARENT_LABEL,
    PbtOnDeviceSuggester,
    resolve_pbt_ondevice,
)
from katib_tpu_torch.utils import observability as obs
from katib_tpu_torch.utils.checkpoint import TrialCheckpointer

torch.set_num_threads(1)

SPECS = (tpbt.HyperSpec("lr", "double", lo=1e-4, hi=1.0, log=True),)
CAT_SPECS = (
    tpbt.HyperSpec("lr", "double", lo=1e-4, hi=1.0, log=True),
    tpbt.HyperSpec("opt", "categorical", values=("sgd", "adam", "lamb")),
    tpbt.HyperSpec("n", "int", lo=1, hi=9),
)


def _jax_specs(specs):
    return tuple(jpbt.HyperSpec(s.name, s.kind, s.lo, s.hi, s.log, s.values) for s in specs)


def _params(k):
    return [{"lr": 10.0 ** -(1 + i % 4), "opt": ("sgd", "adam", "lamb")[i % 3], "n": 1 + i % 9}
            for i in range(k)]


def _jax_draws(key, p, specs, resample_p, winners) -> tpbt.SelectionDraws:
    """The draws JAX's ``exploit_explore`` makes from ``key``, as the port's
    draws: the categorical pick of a winner becomes the uniform that picks
    the same winner (the middle of its slot), the flips and resample
    uniforms pass as they are."""
    key_sel, key_perturb = jax.random.split(key)
    logits = jnp.where(winners, 0.0, -jnp.inf)
    choice = np.asarray(jax.vmap(lambda mk: jax.random.categorical(mk, logits))(
        jax.random.split(key_sel, p)))
    won = np.flatnonzero(np.asarray(winners))
    pick = np.array([(np.searchsorted(won, c) + 0.5) / len(won) if len(won) else 0.5
                     for c in choice], np.float32)
    flip, take, u = {}, {}, {}
    for j, spec in enumerate(specs):
        k_flip, k_draw = jax.random.split(jax.random.fold_in(key_perturb, j))
        if resample_p is None:
            flip[spec.name] = torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5, (p,))))
        else:
            take[spec.name] = torch.from_numpy(np.array(jax.random.uniform(k_flip, (p,))
                                                        < resample_p))
            u[spec.name] = torch.from_numpy(np.array(jax.random.uniform(k_draw, (p,))))
    return tpbt.SelectionDraws(torch.from_numpy(pick), flip, take, u)


# each case: scores (a ghost tail past k), k, truncation, resample_p, specs
SELECTION_CASES = {
    "cut-points": ([0.1, 0.9, 0.5, 0.95, 0.2, 0.4, 0.7, 0.3], 8, 0.25, None, SPECS),
    "exploit-set": ([0.05, 0.9, 0.5, 0.95, 0.02, 0.4, 0.7, 0.6], 8, 0.25, None, SPECS),
    "floor-of-one": ([0.1, 0.9, 0.8], 3, 0.2, None, SPECS),
    "inherit-verbatim": ([0.0, 1.0, 0.5, 0.9, 0.6, 0.55, 0.55, 0.58], 8, 0.25, None, SPECS),
    "categorical-int": (list(np.linspace(0.1, 0.9, 6)), 6, 0.25, None, CAT_SPECS),
    "ties": ([0.5, 0.25, 0.5, 0.25, 0.75, 0.25, 0.5, 0.75], 8, 0.25, None, CAT_SPECS),
    "resample-0": (list(np.linspace(0.1, 0.9, 8)), 8, 0.25, 0.0, CAT_SPECS),
    "resample-half": (list(np.linspace(0.1, 0.9, 8)), 8, 0.3, 0.5, CAT_SPECS),
    "resample-1": (list(np.linspace(0.1, 0.9, 8)), 8, 0.25, 1.0, CAT_SPECS),
    "diverged": ([np.nan, 0.9, 0.5, 0.95, 0.2, 0.4, 0.7, 0.3], 8, 0.25, None, SPECS),
    "ghosts": ([0.1, 0.9, 0.5, 0.95, 0.2, 99.0, 99.0, 99.0], 5, 0.25, None, CAT_SPECS),
    "half": ([0.3, 0.1, 0.2, 0.4, 0.9, 0.8, 0.7, 0.6, 0.5, 0.0], 10, 0.5, None, SPECS),
}


class TestSelectionParity:
    @pytest.mark.parametrize("case", sorted(SELECTION_CASES))
    @pytest.mark.parametrize("seed", [0, 1])
    def test_exploit_explore_equals_jax_on_the_same_draws(self, case, seed):
        scores, k, trunc, resample_p, specs = SELECTION_CASES[case]
        scores = np.asarray(scores, np.float32)
        p = len(scores)
        jspecs = _jax_specs(specs)
        jh = jpbt.encode_hypers(jspecs, _params(k), p)
        key = jax.random.PRNGKey(seed)
        jparent, jhyp, jexpl, jstats = jpbt.exploit_explore(
            key, jnp.asarray(scores), jh, specs=jspecs, k=k, truncation=trunc,
            resample_p=resample_p)
        draws = _jax_draws(key, p, specs, resample_p, jstats["winners"])
        th = tpbt.encode_hypers(specs, _params(k), p)
        parent, hyp, expl, stats = tpbt.exploit_explore(
            torch.from_numpy(scores), th, draws, specs=specs, k=k, truncation=trunc,
            resample_p=resample_p)
        assert parent.tolist() == np.asarray(jparent).tolist()
        assert expl.tolist() == np.asarray(jexpl).tolist()
        assert stats["winners"].tolist() == np.asarray(jstats["winners"]).tolist()
        assert int(stats["n_exploit"]) == int(jstats["n_exploit"])
        assert float(stats["lo"]) == float(jstats["lo"])
        assert float(stats["hi"]) == float(jstats["hi"])
        for spec in specs:
            got, want = hyp[spec.name].numpy(), np.asarray(jhyp[spec.name])
            if resample_p is not None and spec.log:
                # XLA's exp and PyTorch's round the prior draw apart
                np.testing.assert_allclose(got, want, rtol=2 * 2.0**-23, atol=0)
            else:
                np.testing.assert_array_equal(got, want)

    def test_exploit_set_matches_host_segment(self):
        # exactly round_half_up(8 * 0.25) = 2 members below the quantile:
        # the host's truncation and the device's worst-first pick agree
        scores = np.array([0.05, 0.9, 0.5, 0.95, 0.02, 0.4, 0.7, 0.6], np.float32)
        lo, hi = np.quantile(scores, (0.25, 0.75))
        host_exploit = {i for i, s in enumerate(scores) if s < lo}
        host_upper = {i for i, s in enumerate(scores) if s >= hi}
        draws = tpbt.selection_draws(torch.Generator().manual_seed(1), 8, SPECS)
        parent, _, expl, _ = tpbt.exploit_explore(
            torch.from_numpy(scores), tpbt.encode_hypers(SPECS, _params(8)), draws, specs=SPECS,
            k=8, truncation=0.25)
        exploit = {i for i in range(8) if expl[i]}
        assert exploit == host_exploit and len(exploit) == 2
        assert all(int(parent[i]) in host_upper for i in exploit)
        assert all(int(parent[i]) == i for i in range(8) if i not in exploit)

    @pytest.mark.parametrize("seed", range(4))
    def test_perturb_factors_within_one_float32_rounding(self, seed):
        """Explorers multiply by x0.8 or x1.2 in float32 (one rounding of
        the exact product), or sit at a bound as float32 holds it."""
        scores = torch.linspace(0.1, 0.9, 8)
        h = tpbt.encode_hypers(SPECS, _params(8))
        draws = tpbt.selection_draws(torch.Generator().manual_seed(seed), 8, SPECS)
        _, nh, expl, _ = tpbt.exploit_explore(scores, h, draws, specs=SPECS, k=8,
                                               truncation=0.25)
        bounds = {float(np.float32(SPECS[0].lo)), float(np.float32(SPECS[0].hi))}
        for i in range(8):
            if expl[i]:
                continue
            old, new = float(h["lr"][i]), float(nh["lr"][i])
            factors = [float(np.float32(old) * np.float32(f)) for f in (0.8, 1.2)]
            assert new in bounds or any(abs(new - f) <= 2.0**-23 * abs(f) for f in factors)
            assert np.float32(SPECS[0].lo) <= new <= np.float32(SPECS[0].hi)

    def test_ghost_rows_never_win_or_clone(self):
        # ghost rows carry absurdly good scores on purpose
        scores = torch.tensor([0.1, 0.9, 0.5, 0.95, 0.2, 99.0, 99.0, 99.0])
        h = tpbt.encode_hypers(SPECS, _params(5), 8)
        draws = tpbt.selection_draws(torch.Generator().manual_seed(9), 8, SPECS)
        parent, nh, expl, stats = tpbt.exploit_explore(scores, h, draws, specs=SPECS, k=5,
                                                        truncation=0.25)
        assert not stats["winners"][5:].any() and not expl[5:].any()
        assert all(int(parent[i]) < 5 if expl[i] else int(parent[i]) == i for i in range(8))
        assert torch.equal(nh["lr"][5:], h["lr"][5:])

    def test_k_out_of_range_raises(self):
        with pytest.raises(ValueError, match="out of range"):
            tpbt.exploit_explore(torch.zeros(4), tpbt.encode_hypers(SPECS, _params(4)),
                                 tpbt.selection_draws(torch.Generator(), 4, SPECS),
                                 specs=SPECS, k=5, truncation=0.25)


class TestSpaceRoundTrip:
    def test_specs_json_round_trip_and_the_jax_payload(self):
        parameters = [
            ParameterSpec("lr", ParameterType.DOUBLE,
                          FeasibleSpace(min=1e-4, max=1.0, distribution="logUniform")),
            ParameterSpec("opt", ParameterType.CATEGORICAL, FeasibleSpace(list=["sgd", "adam"])),
        ]
        specs = tpbt.specs_from_parameters(parameters)
        payload = tpbt.specs_to_json(specs)
        assert tpbt.specs_from_json(payload) == specs
        assert specs[0].log and specs[0].kind == "double" and specs[1].values == ("sgd", "adam")
        # either package reads the other's pbt_space assignment
        assert _jax_specs(tpbt.specs_from_json(payload)) == jpbt.specs_from_json(payload)
        assert jpbt.specs_to_json(jpbt.specs_from_json(payload)) == payload

    def test_converters_carry_the_jax_tree_and_refuse_another(self):
        params = jax.device_get(jdigits._init_params(jax.random.PRNGKey(3), 64, 10))
        got = pbt_digits_params_from_jax(params)
        assert [tuple(v.shape) for v in got.values()] == [(64, 128), (128,), (128, 10), (10,)]
        assert all(np.array_equal(got[k].numpy(), params[k]) for k in got)
        with pytest.raises(ValueError, match="w1"):
            pbt_digits_params_from_jax({**params, "w3": params["w1"]})
        state = pbt_digits_state_from_jax({"params": params, "velocity": params,
                                           "step": np.arange(3)})
        assert state.step.dtype == torch.int32 and state.step.tolist() == [0, 1, 2]

    def test_encode_decode_members(self):
        h = tpbt.encode_hypers(CAT_SPECS, _params(4), 6)
        assert all(v.shape == (6,) and v.dtype == torch.float32 for v in h.values())
        for i in range(4):
            d = tpbt.decode_member_hypers(CAT_SPECS, h, i)
            assert d["lr"] == pytest.approx(_params(4)[i]["lr"], rel=1e-6)
            assert d["opt"] == _params(4)[i]["opt"] and d["n"] == _params(4)[i]["n"]
        assert tpbt.decode_member_hypers(CAT_SPECS, h, 5) == tpbt.decode_member_hypers(
            CAT_SPECS, h, 0)  # ghost rows repeat member 0


# -- the generation step ------------------------------------------------------


def _digits_population(k, lrs, seed=0):
    """JAX's pbt_digits init for ``k`` members, and the data."""
    ds = jdigits._cached_digits(1400, 397)
    params = jax.device_get(jdigits._init_params(jax.random.PRNGKey(seed), 64, 10))
    state = {"params": params, "velocity": jax.tree_util.tree_map(np.zeros_like, params),
             "step": np.asarray(0, np.int32)}
    stacked = jax.tree_util.tree_map(lambda x: np.stack([x] * k), state)
    return ds, stacked


def _jax_generation(ds, stacked, lrs, idx, truncation):
    specs = (jpbt.HyperSpec("lr", "double", lo=1e-4, hi=1.0),)

    def member_step(state, hrow, mb):
        x, y = mb
        grads = jax.grad(jdigits._loss)(state["params"], x, y)
        velocity = jax.tree_util.tree_map(lambda v, g: 0.9 * v + g, state["velocity"], grads)
        params = jax.tree_util.tree_map(lambda pp, v: pp - hrow["lr"] * v, state["params"],
                                        velocity)
        return {"params": params, "velocity": velocity, "step": state["step"] + 1}

    def member_eval(state, ev):
        x, y = ev
        return (jnp.argmax(jdigits._logits(state["params"], x), axis=-1) == y).mean()

    k = len(lrs)
    gen = jpbt.make_pbt_generation_step(member_step, member_eval, specs=specs, k=k,
                                        truncation=truncation, donate=False)
    data = (jnp.asarray(ds.x_train.reshape(len(ds.x_train), -1)), jnp.asarray(ds.y_train))
    ev = (jnp.asarray(ds.x_test.reshape(len(ds.x_test), -1)), jnp.asarray(ds.y_test))
    hyp = jpbt.encode_hypers(specs, [{"lr": lr} for lr in lrs], k)
    states, _, _, scores, parent, _ = gen(jax.tree_util.tree_map(jnp.asarray, stacked), hyp,
                                          jax.random.PRNGKey(0), jnp.asarray(idx, jnp.int32),
                                          data, ev)
    return jax.device_get(states), np.asarray(scores), np.asarray(parent)


def _port_generation(ds, stacked, lrs, truncation, capture=None, device="cpu"):
    specs = (tpbt.HyperSpec("lr", "double", lo=1e-4, hi=1.0),)
    k = len(lrs)
    state = pbt_digits_state_from_jax(stacked)
    state = TrainState(state.step.to(device), {n: v.to(device) for n, v in state.params.items()},
                       {n: v.to(device) for n, v in state.opt_state.items()})
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return tpbt.make_pbt_generation_step(
        tdigits.member_loss, tdigits.member_update, tdigits.member_eval, states=state,
        hypers=tpbt.encode_hypers(specs, [{"lr": lr} for lr in lrs], k, device=device),
        data=(to(ds.x_train.reshape(len(ds.x_train), -1)), to(ds.y_train)),
        eval_batch=(to(ds.x_test.reshape(len(ds.x_test), -1)), to(ds.y_test)),
        steps=5, batch_size=16, specs=specs, k=k, truncation=truncation, capture=capture)


class TestGenerationStep:
    def test_train_part_equals_jax_float32(self):
        """Truncation 0 selects no one, so the generation's states are its T
        train steps: the port's equal JAX's from the same weights and
        minibatches; the scores (test accuracy) agree."""
        lrs = [0.01, 0.05, 0.1, 0.3]
        ds, stacked = _digits_population(4, lrs)
        idx = np.random.default_rng((7, 0)).integers(0, 1400, size=(5, 16))
        want, want_scores, want_parent = _jax_generation(ds, stacked, lrs, idx, 0.0)
        gen = _port_generation(ds, stacked, lrs, 0.0)
        scores, parent, expl = gen(idx, torch.Generator().manual_seed(0))
        assert parent.tolist() == want_parent.tolist() == [0, 1, 2, 3] and not expl.any()
        np.testing.assert_allclose(scores.numpy(), want_scores, atol=1 / 397)
        got = gen.states
        assert got.step.tolist() == want["step"].tolist() == [5] * 4
        for n in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(got.params[n].numpy(), want["params"][n],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got.opt_state[n].numpy(), want["velocity"][n],
                                       rtol=1e-5, atol=1e-6)
        assert gen.loop.losses.shape == (5, 4) and torch.isfinite(gen.loop.losses).all()

    def test_selection_clones_state_rows_and_writes_hypers(self):
        lrs = [0.001, 0.05, 0.1, 0.3, 0.2, 0.0001]
        ds, stacked = _digits_population(6, lrs)
        gen = _port_generation(ds, stacked, lrs, 0.25)
        idx = np.random.default_rng(0).integers(0, 1400, size=(5, 16))
        gen.loop.run_epoch(idx)
        trained = {n: v.clone() for n, v in gen.states.params.items()}
        before = gen.hypers["lr"].clone()
        gen.loop.run_epoch = lambda idx: None  # the rows trained above
        scores, parent, expl = gen(idx, torch.Generator().manual_seed(3))
        assert expl.any()
        for n, v in trained.items():
            assert torch.equal(gen.states.params[n], v.index_select(0, parent))
        for i in range(6):
            if expl[i]:
                assert gen.hypers["lr"][i] == before[parent[i]]

    def test_same_seed_rerun_is_bit_equal(self):
        def run():
            lrs = [0.001, 0.01, 0.05, 0.1, 0.3, 0.5]
            ds, stacked = _digits_population(6, lrs)
            gen = _port_generation(ds, stacked, lrs, 0.25)
            out = []
            for g in range(3):
                idx = np.random.default_rng((7, g)).integers(0, 1400, size=(5, 16))
                scores, parent, _ = gen(idx, torch.Generator().manual_seed(
                    tpbt.generation_seed(7, g)))
                out.append((scores.tolist(), parent.tolist(), gen.hypers["lr"].tolist()))
            return out, [v.clone() for v in gen.states.params.values()]

        (hist_a, params_a), (hist_b, params_b) = run(), run()
        assert hist_a == hist_b
        assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


# -- the suggester ------------------------------------------------------------


def _ondevice_spec(tmp_path, *, population=6, generations=3, steps=15, name=None, **kw):
    settings = {
        "n_population": str(population),
        "truncation_threshold": "0.25",
        "generations": str(generations),
        "steps_per_generation": str(steps),
        "suggestion_trial_dir": str(tmp_path / "pbt"),
        "random_state": "7",
    }
    settings.update(kw.pop("settings", {}))
    return ExperimentSpec(
        name=name or "pbt-ondev-test",
        objective=ObjectiveSpec(type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy"),
        algorithm=AlgorithmSpec(name="pbt-ondevice", settings=settings),
        parameters=[ParameterSpec("lr", ParameterType.DOUBLE, FeasibleSpace(min=1e-4, max=0.5))],
        train_fn=tdigits.pbt_digits_trial,
        max_trial_count=population,
        parallel_trial_count=population,
        **kw,
    )


class TestOnDeviceSuggester:
    def test_single_dispatch_then_exhausted(self, tmp_path, monkeypatch):
        monkeypatch.delenv("KATIB_PBT_ONDEVICE", raising=False)
        spec = _ondevice_spec(tmp_path)
        s = make_suggester(spec)
        assert isinstance(s, PbtOnDeviceSuggester) and s.on_device
        exp = Experiment(spec=spec)
        batch = s.get_suggestions(exp, 2)  # asked for 2, the population wins
        assert len(batch) == 6
        assert all(p.labels[COHORT_KEY_LABEL] == ONDEVICE_COHORT_KEY for p in batch)
        assert all(p.labels[GENERATION_LABEL] == "0" for p in batch)
        shared = batch[0].as_dict()
        assert shared["pbt_generations"] == 3 and shared["pbt_steps_per_generation"] == 15
        assert tpbt.specs_from_json(shared["pbt_space"])[0].name == "lr"
        assert [p.as_dict()["pbt_slot"] for p in batch] == list(range(6))
        assert s.get_suggestions(exp, 6) == []
        # the grouping window was widened to hold the whole population
        assert spec.cohort_width >= 6

    def test_dispatched_survives_state_round_trip(self, tmp_path, monkeypatch):
        monkeypatch.delenv("KATIB_PBT_ONDEVICE", raising=False)
        spec = _ondevice_spec(tmp_path)
        s = make_suggester(spec)
        exp = Experiment(spec=spec)
        s.get_suggestions(exp, 6)
        fresh = make_suggester(_ondevice_spec(tmp_path))
        fresh.load_state_dict(s.state_dict())
        assert fresh.get_suggestions(exp, 6) == []

    def test_escape_hatch_falls_back_to_host_path(self, tmp_path, monkeypatch):
        monkeypatch.delenv("KATIB_PBT_ONDEVICE", raising=False)
        spec = _ondevice_spec(tmp_path, settings={"on_device": "false"})
        assert not resolve_pbt_ondevice(spec)
        s = make_suggester(spec)
        got = s.get_suggestions(Experiment(spec=spec), 2)  # the host path honors count
        assert len(got) == 2 and COHORT_KEY_LABEL not in got[0].labels
        assert os.path.isdir(s.checkpoint_dir_for(got[0].name))

    def test_env_switch_wins(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KATIB_PBT_ONDEVICE", "0")
        assert not resolve_pbt_ondevice(_ondevice_spec(tmp_path))
        monkeypatch.setenv("KATIB_PBT_ONDEVICE", "1")
        assert resolve_pbt_ondevice(_ondevice_spec(tmp_path, settings={"on_device": "false"}))
        monkeypatch.delenv("KATIB_PBT_ONDEVICE")
        assert not resolve_pbt_ondevice(_ondevice_spec(tmp_path, pbt_ondevice=False))

    def test_validate_budget_covers_population(self, tmp_path, monkeypatch):
        monkeypatch.delenv("KATIB_PBT_ONDEVICE", raising=False)
        spec = _ondevice_spec(tmp_path)
        spec.max_trial_count = 4
        with pytest.raises(SuggesterError, match="max_trial_count"):
            PbtOnDeviceSuggester.validate(spec)


# -- end to end ---------------------------------------------------------------


def _trials(spec, s, proposals, names=None):
    return [
        Trial(name=names[i] if names else p.name, experiment_name=spec.name,
              spec=TrialSpec(assignments=list(p.assignments), labels=dict(p.labels),
                             train_fn=tdigits.pbt_digits_trial),
              checkpoint_dir=s.checkpoint_dir_for(p.name))
        for i, p in enumerate(proposals)
    ]


class TestOnDeviceEndToEnd:
    """Orchestrator- and cohort-driven on-device PBT (real digits, CPU)."""

    @pytest.mark.parametrize("async_orch", [False, True])
    def test_lineage_settles_like_host_path(self, tmp_path, monkeypatch, async_orch):
        from katib_tpu_torch.orchestrator import Orchestrator

        monkeypatch.delenv("KATIB_PBT_ONDEVICE", raising=False)
        gen_before, fb_before = obs.pbt_generations.get(), obs.cohort_fallbacks.get()
        spec = _ondevice_spec(tmp_path, async_orch=async_orch)
        exp = Orchestrator(workdir=str(tmp_path / "wd"), device="cpu").run(spec)
        done = [t for t in exp.trials.values() if t.condition.is_completed_ok()]
        assert len(done) == 6
        names = {t.name for t in done}
        for t in done:
            # the label shape the host path stamps on next-gen members
            assert t.spec.labels[GENERATION_LABEL] == "3"
            assert t.spec.labels[PARENT_LABEL] in names
            assert t.objective_value(spec.objective) is not None
        assert obs.pbt_generations.get() - gen_before == 3
        assert obs.cohort_fallbacks.get() == fb_before

    def test_drain_resume_loses_no_member(self, tmp_path, monkeypatch):
        """Drain at the first generation boundary; the resume runs the
        remaining generations with every member's state, and the same
        generations as an uninterrupted run."""
        monkeypatch.delenv("KATIB_PBT_ONDEVICE", raising=False)
        spec = _ondevice_spec(tmp_path, generations=3)
        s = make_suggester(spec)
        proposals = s.get_suggestions(Experiment(spec=spec), 6)
        drain = threading.Event()
        drain.set()  # drain at the FIRST boundary: exactly one generation
        results = run_cohort(_trials(spec, s, proposals), MemoryObservationStore(),
                             spec.objective, drain_event=drain, device="cpu")
        assert all(r.condition is TrialCondition.DRAINED for r in results.values())
        for p in proposals:
            assert TrialCheckpointer(s.checkpoint_dir_for(p.name)).all_steps() == [0]
        store = MemoryObservationStore()
        results = run_cohort(_trials(spec, s, proposals), store, spec.objective, device="cpu")
        assert all(r.condition is TrialCondition.SUCCEEDED for r in results.values())
        for p in proposals:
            # generations 1..2 ran on resume — generation 0 was not redone
            assert [m.step for m in store.get(p.name, "accuracy")] == [1, 2]
        # the uninterrupted run reports the same generations 1 and 2
        spec2 = _ondevice_spec(tmp_path / "whole", generations=3, name="whole")
        s2 = make_suggester(spec2)
        store2 = MemoryObservationStore()
        run_cohort(_trials(spec2, s2, s2.get_suggestions(Experiment(spec=spec2), 6),
                           names=[p.name for p in proposals]), store2, spec2.objective,
                   device="cpu")
        for p in proposals:
            assert [m.value for m in store.get(p.name, "accuracy")] == [
                m.value for m in store2.get(p.name, "accuracy")][1:]

    def test_a_drained_member_resumes_through_the_host_trial(self, tmp_path, monkeypatch):
        monkeypatch.delenv("KATIB_PBT_ONDEVICE", raising=False)
        spec = _ondevice_spec(tmp_path, generations=2, steps=5)
        s = make_suggester(spec)
        proposals = s.get_suggestions(Experiment(spec=spec), 6)
        drain = threading.Event()
        drain.set()
        run_cohort(_trials(spec, s, proposals), MemoryObservationStore(), spec.objective,
                   drain_event=drain, device="cpu")
        ckpt = s.checkpoint_dir_for(proposals[0].name)
        tree, _ = TrialCheckpointer(ckpt).restore()
        assert {"hypers/lr", "generation", "step"} <= set(tree) and int(tree["step"]) == 5
        ctx = TrialContext({"lr": "0.05", "steps_per_round": "3"}, checkpoint_dir=ckpt,
                           device="cpu")
        tdigits.pbt_digits_trial(ctx)
        assert [step for step, _ in ctx.reports] == [8]  # steps 6, 7, 8 after step 5

    def test_ghost_rows_in_a_bucket_of_8(self, tmp_path, monkeypatch):
        monkeypatch.delenv("KATIB_PBT_ONDEVICE", raising=False)
        spec = _ondevice_spec(tmp_path, population=5, generations=2, steps=5)
        s = make_suggester(spec)
        proposals = s.get_suggestions(Experiment(spec=spec), 5)
        store = MemoryObservationStore()
        results = run_cohort(_trials(spec, s, proposals), store, spec.objective, buckets=True,
                             device="cpu")
        assert all(r.condition is TrialCondition.SUCCEEDED for r in results.values())
        names = {p.name for p in proposals}
        for p in proposals:
            parents = [int(m.value) for m in store.get(p.name, "pbt_parent")]
            assert len(parents) == 2 and all(0 <= q < 5 for q in parents)
        for t in _trials(spec, s, proposals):
            assert TrialCheckpointer(t.checkpoint_dir).all_steps() == [0, 1]
        assert len(names) == 5

    def test_host_trial_reports_as_the_jax_trial(self, tmp_path, monkeypatch):
        """``pbt_digits_trial`` from JAX's init (carried by ``convert.py``),
        then resumed from its own checkpoint: the same steps and accuracies."""
        jparams = jax.device_get(jdigits._init_params(jax.random.PRNGKey(0), 64, 10))
        monkeypatch.setattr(tdigits, "_init_params",
                            lambda gen, d_in, nc, dev=None: pbt_digits_params_from_jax(jparams))
        from katib_tpu.runner.context import TrialContext as JaxTrialContext
        from katib_tpu.store.base import MemoryObservationStore as JaxStore

        jstore = JaxStore()
        got = []
        for round_ in range(2):
            jctx = JaxTrialContext("t", {"lr": "0.1", "steps_per_round": "10"}, jstore,
                                   checkpoint_dir=str(tmp_path / "jax"))
            jdigits.pbt_digits_trial(jctx)
            ctx = TrialContext({"lr": "0.1", "steps_per_round": "10"},
                               checkpoint_dir=str(tmp_path / "torch"), device="cpu")
            tdigits.pbt_digits_trial(ctx)
            got += [(step, m["accuracy"]) for step, m in ctx.reports]
        want = [(m.step, m.value) for m in jstore.get("t", "accuracy")]
        assert [s for s, _ in got] == [s for s, _ in want] == [9, 19]
        np.testing.assert_allclose([a for _, a in got], [a for _, a in want], atol=1 / 397)
