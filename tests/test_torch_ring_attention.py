"""The port's sequence-parallel attention and sharded LM against the JAX
package's (the cases of ``tests/test_attention_transformer.py``'s
``TestSequenceParallelAttention`` and ``TestTransformerLM``).

The JAX side runs under ``shard_map`` on the conftest's 8 virtual CPU
devices, attending through its dense reference on the CPU; the port's
runs one replica per entry of a CPU grid, attending through the plain
version of its flash kernels.  Tolerances are stated at each comparison.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katib_tpu.models.transformer import TransformerLM as JLM
from katib_tpu.models.transformer import make_attention_fn as j_make_attention_fn
from katib_tpu.models.transformer import train_lm as j_train_lm
from katib_tpu.parallel import mesh as jmesh
from katib_tpu.parallel.ring_attention import (
    make_sequence_parallel_attention as j_make_sp_attention,
)
from katib_tpu_torch.convert import transformer_state_dict_from_flax
from katib_tpu_torch.models.transformer import (
    TransformerLM,
    make_attention_fn,
    markov_dataset,
    train_lm,
    transformer_trial,
)
from katib_tpu_torch.ops.flash_attention import flash_attention_with_lse, reference_attention
from katib_tpu_torch.parallel import mesh as tmesh
from katib_tpu_torch.parallel.ring_attention import make_sequence_parallel_attention

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

AXES = {"data": 2, "seq": 4}


def _qkv(b=4, h=4, s=64, d=16, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(3))


def _meshes(axes=AXES):
    n = int(np.prod(list(axes.values())))
    return jmesh.make_mesh(axes, devices=jax.devices()[:n]), tmesh.make_mesh(axes, ["cpu"] * n)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_and_dense(strategy, causal):
    jm, tm = _meshes()
    q, k, v = _qkv()
    want = np.asarray(jax.jit(j_make_sp_attention(jm, strategy=strategy, causal=causal))(
        *map(jnp.asarray, (q, k, v))))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = make_sequence_parallel_attention(tm, strategy=strategy, causal=causal)(tq, tk, tv)
    # float32: 1e-5 against the JAX function, 1e-4 against dense (the JAX test's)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), reference_attention(tq, tk, tv, causal=causal).numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_gradients_match_jax(strategy):
    jm, tm = _meshes()
    q, k, v = _qkv(b=2, h=4, s=32, d=8, seed=2)
    attn = j_make_sp_attention(jm, strategy=strategy, causal=True)
    want = jax.jit(jax.grad(lambda a, b, c: jnp.sum(jnp.sin(attn(a, b, c))), argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    out = make_sequence_parallel_attention(tm, strategy=strategy, causal=True)(tq, tk, tv)
    got = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    dense = reference_attention(tq, tk, tv, causal=True)
    ref = torch.autograd.grad(torch.sin(dense).sum(), (tq, tk, tv))
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4)


def test_seq_axis_of_one_degenerates_to_the_single_device_call():
    jm, tm = _meshes({"data": 8, "seq": 1})
    q, k, v = _qkv(b=8, h=2, s=32, d=8)
    calls = []

    def inner(a, b, c, causal):
        calls.append(a.shape)
        return flash_attention_with_lse(a, b, c, causal)

    got = make_sequence_parallel_attention(tm, strategy="ring", inner=inner)(
        *map(torch.from_numpy, (q, k, v)))
    want = j_make_sp_attention(jm, strategy="ring")(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert calls == [torch.Size((8, 2, 32, 8))]  # one call on the whole batch


@pytest.mark.parametrize("causal, want_calls", [(True, 4 * 5 // 2), (False, 16)])
def test_the_causal_ring_launches_no_inner_call_for_a_later_chunk(causal, want_calls):
    """A later chunk is skipped without a call: 1 + 2 + 3 + 4 = 10 calls for
    a causal ring of 4 replicas (against 16 without the mask), and each
    replica's calls are its full chunks and one diagonal chunk."""
    _, tm = _meshes({"seq": 4})
    q, k, v = map(torch.from_numpy, _qkv(b=1, h=2, s=32, d=8))
    calls = []

    def inner(a, b, c, is_causal):
        calls.append(is_causal)
        return flash_attention_with_lse(a, b, c, is_causal)

    out = make_sequence_parallel_attention(tm, causal=causal, inner=inner)(q, k, v)
    assert len(calls) == want_calls
    assert calls.count(True) == (4 if causal else 0)
    np.testing.assert_allclose(out.numpy(), reference_attention(q, k, v, causal=causal).numpy(),
                               atol=1e-5)


def test_ulysses_needs_heads_divisible_by_the_seq_axis():
    _, tm = _meshes({"seq": 4})
    q, k, v = map(torch.from_numpy, _qkv(b=1, h=2, s=32, d=8))
    with pytest.raises(ValueError, match="multiple of the seq-axis size"):
        make_sequence_parallel_attention(tm, strategy="ulysses")(q, k, v)
    with pytest.raises(ValueError, match="unknown"):
        make_sequence_parallel_attention(tm, strategy="tree")


CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=1, max_seq_len=32)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_train_lm_on_a_mesh_follows_the_jax_loop(strategy):
    """Three steps of both ``train_lm`` loops on {data: 2, seq: 4}, float32,
    from the JAX model's own initial weights: every train and eval loss
    within 1e-5 relative (float32, compounded over three AdamW updates)."""
    jm, tm = _meshes()
    jlm = JLM(**CFG, dtype=jnp.float32, attn_fn=j_make_attention_fn(jm, strategy=strategy))
    params = jax.tree_util.tree_map(np.asarray, JLM(**CFG, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((2, CFG["max_seq_len"]), jnp.int32)))
    data = markov_dataset(CFG["vocab_size"], 40, CFG["max_seq_len"], seed=0)
    kwargs = dict(lr=3e-3, steps=3, batch_size=4, report_every=1, seed=0)
    jax_log, port_log = [], []
    j_final = j_train_lm(jlm, data, mesh=jm, **kwargs,
                         report=lambda step, loss, eval_loss: jax_log.append((step, loss,
                                                                              eval_loss)))
    model = TransformerLM(**CFG, dtype=torch.float32, attn_fn=make_attention_fn(tm, strategy))
    model.load_state_dict(transformer_state_dict_from_flax(params, model))
    p_final = train_lm(model, data, mesh=tm, **kwargs,
                       report=lambda step, loss, eval_loss: port_log.append((step, loss,
                                                                             eval_loss)))
    assert [s for s, *_ in port_log] == [s for s, *_ in jax_log] == [0, 1, 2]
    np.testing.assert_allclose(np.array(port_log)[:, 1:], np.array(jax_log)[:, 1:], rtol=1e-5)
    assert p_final == pytest.approx(j_final, rel=1e-5)


def test_a_sharded_dropout_run_draws_what_the_unsharded_run_draws():
    """With dropout the masks are drawn for the global batch and sliced, so
    the sharded run equals the port's own unsharded run (1e-5 relative)."""
    _, tm = _meshes()
    data = markov_dataset(CFG["vocab_size"], 40, CFG["max_seq_len"], seed=0)

    def run(mesh):
        model = TransformerLM(**CFG, dtype=torch.float32, dropout=0.2,
                              attn_fn=make_attention_fn(mesh) if mesh is not None else None)
        model.reset_parameters(torch.Generator().manual_seed(0))
        log = []
        final = train_lm(model, data, lr=3e-3, steps=3, batch_size=4, report_every=1, mesh=mesh,
                         device="cpu", report=lambda step, loss, eval_loss: log.append(loss))
        return log, final

    (got, got_final), (want, want_final) = run(tm), run(None)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got_final == pytest.approx(want_final, rel=1e-5)


def _orch_spec(package, trial, attn):
    types = package.core.types
    fixed = [
        types.ParameterSpec(name, types.ParameterType.INT, types.FeasibleSpace(min=v, max=v))
        for name, v in (("steps", 4), ("d_model", 32), ("seq_len", 64), ("n_seq", 64),
                        ("batch_size", 8))
    ]
    fixed.append(types.ParameterSpec("attn", types.ParameterType.CATEGORICAL,
                                     types.FeasibleSpace(list=[attn])))
    return types.ExperimentSpec(
        name="tlm-random",
        algorithm=types.AlgorithmSpec(name="random"),
        objective=types.ObjectiveSpec(type=types.ObjectiveType.MINIMIZE,
                                      objective_metric_name="eval_loss"),
        parameters=[types.ParameterSpec("lr", types.ParameterType.DOUBLE,
                                        types.FeasibleSpace(min=1e-3, max=1e-2)), *fixed],
        max_trial_count=2,
        parallel_trial_count=1,
        train_fn=trial,
    )


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_transformer_trial_via_orchestrator_on_a_mesh(attn):
    """End to end on {data: 2, seq: 2} through both orchestrators: the e2e
    invariants (experiment condition, completed trials, an optimal trial
    with a finite objective)."""
    import katib_tpu
    import katib_tpu.core.types  # noqa: F401
    import katib_tpu_torch
    import katib_tpu_torch.core.types  # noqa: F401
    from katib_tpu.models.transformer import transformer_trial as j_transformer_trial
    from katib_tpu.orchestrator import Orchestrator as JOrchestrator
    from katib_tpu_torch.orchestrator.orchestrator import Orchestrator

    jm, tm = _meshes({"data": 2, "seq": 2})
    seen = []

    def trial(ctx):
        seen.append(ctx.mesh)
        transformer_trial(ctx)

    out = {}
    for name, package, exp in (
        ("jax", katib_tpu, lambda: JOrchestrator(mesh=jm).run(
            _orch_spec(katib_tpu, j_transformer_trial, attn))),
        ("port", katib_tpu_torch, lambda: Orchestrator(mesh=tm, device="cpu").run(
            _orch_spec(katib_tpu_torch, trial, attn))),
    ):
        e = exp()
        value = e.optimal.observation.metrics[0].value if e.optimal is not None else None
        out[name] = (e.condition.value, e.completed_count, value is not None and
                     np.isfinite(float(value)))
    assert out["port"] == out["jax"] == ("MaxTrialsReached", 2, True)
    assert seen == [tm, tm]
