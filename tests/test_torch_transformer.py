"""The port's long-context transformer trial against the JAX package's.

Float32 on both sides, small widths (vocab 64, d_model 32, 4 heads, 2
layers, seq 32).  Weights start from the JAX model's own initialisation and
are carried across with ``transformer_state_dict_from_flax``; the JAX side
attends through its dense reference on the CPU and the port through its
plain version.  Tolerances are stated at each comparison.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from katib_tpu.models.transformer import TransformerLM as JLM
from katib_tpu.models.transformer import lm_loss as j_lm_loss
from katib_tpu.models.transformer import markov_dataset as j_markov_dataset
from katib_tpu.models.transformer import train_lm as j_train_lm
from katib_tpu_torch.convert import transformer_state_dict_from_flax
from katib_tpu_torch.models import TransformerLM, markov_dataset, transformer_trial
from katib_tpu_torch.models.transformer import (
    dropout,
    lm_loss,
    make_attention_fn,
    train_lm,
)
from katib_tpu_torch.ops.flash_attention import flash_attention
from katib_tpu_torch.parallel.train import adamw_with_schedule, warmup_cosine_decay
from katib_tpu_torch.runner.context import TrialContext

# tier-1 runs six test processes on the same cores: one torch thread each
torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_seq_len=32)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the flash kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def _port_model(params, attn_fn=None, dropout_rate=0.0) -> TransformerLM:
    model = TransformerLM(**CFG, dropout=dropout_rate, dtype=torch.float32,
                          attn_fn=attn_fn or make_attention_fn())
    model.load_state_dict(transformer_state_dict_from_flax(params, model))
    return model


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model (float32) and its initial params, as ``train_lm`` draws them."""
    jm = JLM(**CFG, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, CFG["max_seq_len"]), jnp.int32))
    return jm, jax.tree_util.tree_map(np.asarray, params)


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize(
    "vocab,n_seq,seq_len,seed,branching",
    [(256, 16, 64, 0, 4), (64, 7, 33, 3, 2), (1000, 4, 128, 11, 8)],
)
def test_markov_dataset_is_bit_identical(vocab, n_seq, seq_len, seed, branching):
    got = markov_dataset(vocab, n_seq, seq_len, seed=seed, branching=branching)
    want = j_markov_dataset(vocab, n_seq, seq_len, seed=seed, branching=branching)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# -- schedule and optimizer ---------------------------------------------------


@pytest.mark.parametrize("lr,steps,warmup_frac", [(3e-3, 60, 0.1), (1e-2, 7, 0.3), (5e-4, 2, 0.0)])
def test_schedule_matches_optax(lr, steps, warmup_frac):
    """Within 1e-6 of the peak: optax evaluates the cosine in float32, the
    port in float64."""
    warmup = max(1, int(steps * warmup_frac))
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)
    got = warmup_cosine_decay(0.0, lr, warmup, steps)
    assert got(0) == float(want(0)) == 0.0
    for c in range(steps + 3):
        assert got(c) == pytest.approx(float(want(c)), rel=0, abs=1e-6 * lr)


def test_schedule_refuses_what_optax_refuses():
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 1)
    with pytest.raises(ValueError):
        warmup_cosine_decay(0.0, 1e-3, 1, 1)


def test_first_step_runs_at_lr_zero_and_the_lr_follows_optax_counts():
    """optax evaluates the schedule at the count before each update."""
    steps, lr = 6, 1e-2
    sched = warmup_cosine_decay(0.0, lr, 2, steps)
    w = torch.nn.Parameter(torch.ones(3))
    opt, lr_sched = adamw_with_schedule([w], sched)
    seen = []
    for _ in range(steps):
        seen.append(opt.param_groups[0]["lr"])
        w.grad = torch.ones(3)
        opt.step()
        lr_sched.step()
    assert seen[0] == 0.0
    want = optax.warmup_cosine_decay_schedule(0.0, lr, 2, steps)
    np.testing.assert_allclose(seen, [float(want(c)) for c in range(steps)], rtol=1e-6, atol=0)


def test_adamw_updates_match_optax():
    """Five AdamW steps with weight decay on random params and gradients:
    float32 on both sides, within 1e-6 (rounding order only)."""
    rng = np.random.default_rng(0)
    steps, lr = 5, 1e-2
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(steps)]
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, 2, steps), weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, lr_sched = adamw_with_schedule(list(tp.values()), warmup_cosine_decay(0.0, lr, 2, steps))
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        lr_sched.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    assert not np.allclose(tp["a"].detach().numpy(), p0["a"])


# -- the model ----------------------------------------------------------------


@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_logits_and_gradients_match_jax(jax_init, attention):
    """Logits within 1e-5; each gradient within 1e-5 of its largest entry."""
    jm, params = jax_init
    tokens = np.random.default_rng(1).integers(0, CFG["vocab_size"], size=(2, 32)).astype(np.int32)
    jt = jnp.asarray(tokens)
    want_logits = jm.apply(params, jt)
    want_grads = jax.grad(lambda p: j_lm_loss(jm.apply(p, jt), jt))(params)

    attn = None if attention == "plain" else (lambda q, k, v: flash_attention(q, k, v, causal=True))
    model = _port_model(params, attn_fn=attn)
    tt = torch.from_numpy(tokens).long()
    logits = model(tt)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=0, atol=1e-5)
    lm_loss(logits, tt).backward()
    want = transformer_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want_grads), model)
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max())
        torch.testing.assert_close(p.grad, want[name], rtol=0, atol=1e-5 * scale,
                                   msg=lambda m, name=name: f"{name}: {m}")


def test_train_lm_follows_the_jax_loop(jax_init):
    """Five steps of both ``train_lm`` loops from the same weights on the
    same batches: every per-step train loss and every eval loss within
    1e-5 relative (float32 rounding, compounded over five AdamW updates)."""
    jm, params = jax_init
    data = markov_dataset(CFG["vocab_size"], 40, CFG["max_seq_len"], seed=0)
    kwargs = dict(lr=3e-3, steps=5, batch_size=4, report_every=1, seed=0)
    jax_log, port_log = [], []
    j_final = j_train_lm(jm, data, **kwargs,
                         report=lambda step, loss, eval_loss: jax_log.append((step, loss, eval_loss)))
    model = _port_model(params)
    p_final = train_lm(model, data, **kwargs, device="cpu",
                       report=lambda step, loss, eval_loss: port_log.append((step, loss, eval_loss)))
    assert [s for s, *_ in port_log] == [s for s, *_ in jax_log] == list(range(5))
    np.testing.assert_allclose(np.array(port_log)[:, 1:], np.array(jax_log)[:, 1:], rtol=1e-5)
    assert p_final == pytest.approx(j_final, rel=1e-5)


def test_report_false_stops_training(jax_init):
    _, params = jax_init
    data = markov_dataset(CFG["vocab_size"], 40, CFG["max_seq_len"], seed=0)
    calls = []
    train_lm(_port_model(params), data, lr=3e-3, steps=20, batch_size=4, report_every=2,
             device="cpu", report=lambda step, loss, eval_loss: calls.append(step) or step < 4)
    assert calls == [0, 2, 4]


# -- the trial ----------------------------------------------------------------

TRIAL = {"vocab_size": "32", "d_model": "32", "n_heads": "2", "n_layers": "1", "seq_len": "16",
         "n_seq": "32", "batch_size": "4", "steps": "3"}


def test_transformer_trial_reports_finite_losses_on_the_cpu():
    times = []
    ctx = TrialContext(TRIAL, device="cpu", step_times=times)
    transformer_trial(ctx)
    assert [s for s, _ in ctx.reports] == [0, 2]
    for _, metrics in ctx.reports:
        assert set(metrics) == {"loss", "eval_loss"}
        assert all(np.isfinite(v) for v in metrics.values())
    assert len(times) == 3 and all(t > 0 for t in times)


def test_trial_context_has_the_jax_contexts_mesh():
    assert TrialContext({}).mesh is None


def test_mesh_asks_for_sequence_parallelism_not_ported_yet():
    """Ported since: a mesh asks for ring (or Ulysses) sequence parallelism,
    which equals the plain attention (1e-5), and the trial runs on it
    (``test_torch_ring_attention.py`` holds both to the JAX package's)."""
    from katib_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"seq": 2}, devices=["cpu"] * 2)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 16, 8, generator=g) for _ in range(3))
    for strategy in ("ring", "ulysses"):
        torch.testing.assert_close(make_attention_fn(mesh, strategy)(q, k, v),
                                   make_attention_fn()(q, k, v), rtol=0, atol=1e-5)
    ctx = TrialContext(TRIAL, device="cpu", mesh=mesh)
    transformer_trial(ctx)
    assert [s for s, _ in ctx.reports] == [0, 2]
    assert all(np.isfinite(v) for _, m in ctx.reports for v in m.values())


# -- weights carried across ---------------------------------------------------


def test_converter_refuses_missing_leftover_and_misshapen(jax_init):
    _, params = jax_init
    model = TransformerLM(**CFG, dtype=torch.float32)
    tree = jax.tree_util.tree_map(lambda a: a, params["params"])
    missing = {**tree, "Block_1": {k: v for k, v in tree["Block_1"].items() if k != "Dense_2"}}
    with pytest.raises(KeyError, match="Block_1/Dense_2"):
        transformer_state_dict_from_flax(missing, model)
    with pytest.raises(KeyError, match="no port counterpart"):
        transformer_state_dict_from_flax({**tree, "Dense_9": {"kernel": np.zeros(2)}}, model)
    bad = {**tree, "Dense_0": {**tree["Dense_0"], "bias": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        transformer_state_dict_from_flax(bad, model)


def test_reset_parameters_draws_flax_default_distributions():
    model = TransformerLM(vocab_size=512, d_model=256, n_heads=4, n_layers=1, max_seq_len=512,
                          dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    emb = model.tok_embed.embedding.detach()
    assert float(emb.std()) == pytest.approx(256 ** -0.5, rel=0.02)
    kernel = model.blocks[0].fc1.kernel.detach()  # lecun normal: std 1/sqrt(fan_in), cut at 2 std
    assert float(kernel.std()) == pytest.approx(256 ** -0.5, rel=0.02)
    assert float(kernel.abs().max()) <= 2 * 256 ** -0.5 / 0.87962566103423978 + 1e-6
    assert torch.equal(model.blocks[0].ln1.scale, torch.ones(256))
    assert not model.blocks[0].fc1.bias.any() and model.blocks[0].qkv.bias is None


# -- dropout ------------------------------------------------------------------


def test_dropout_is_inverted_and_drawn_from_its_generator():
    x = torch.randn(200_000, generator=torch.Generator().manual_seed(0))
    assert dropout(x, 0.0, None) is x
    assert not dropout(x, 1.0, torch.Generator()).any()
    y = dropout(x, 0.3, torch.Generator().manual_seed(1))
    kept = y != 0
    assert float(kept.float().mean()) == pytest.approx(0.7, abs=0.005)
    torch.testing.assert_close(y[kept], x[kept] / 0.7, rtol=0, atol=0)
    assert torch.equal(y, dropout(x, 0.3, torch.Generator().manual_seed(1)))
    assert not torch.equal(y, dropout(x, 0.3, torch.Generator().manual_seed(2)))


def test_dropout_acts_only_when_not_deterministic(jax_init):
    _, params = jax_init
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 64, size=(2, 32)))
    plain = _port_model(params)(tokens)
    model = _port_model(params, dropout_rate=0.5)
    torch.testing.assert_close(model(tokens), plain, rtol=0, atol=0)
    noisy = model(tokens, deterministic=False, generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(noisy, plain)


@pytest.mark.cuda
def test_one_training_step_on_the_card_launches_every_kernel(cuda_device):
    from katib_tpu_torch.ops import flash_attention as fa

    params = {**TRIAL, "d_model": "64", "n_heads": "2", "n_layers": "2", "steps": "2",
              "seq_len": "128"}
    ctx = TrialContext(params, device=str(cuda_device))
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    transformer_trial(ctx)
    # 2 layers x (2 steps + 2 evaluations) forwards, 2 layers x 2 steps backwards
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == (8, 4, 4)
    assert all(np.isfinite(v) for _, m in ctx.reports for v in m.values())
