"""The port's cost model (``katib_tpu_torch/costmodel/``) on the CPU: the
record and its roofline against the JAX record on the same numbers, the
peaks table (an ``h100`` row, the ``cpu`` row, no default), each
hand-written kernel's declared work at the shapes ``PERF.md`` section 6
bounds, the count itself, the live slot, the registry's cost rows, the
heartbeat publication through ``run_trial``, the ``cost`` verb and
``trace summary --top``."""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import textwrap
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from katib_tpu.costmodel import peaks as j_peaks
from katib_tpu.costmodel.record import CostRecord as JCostRecord
from katib_tpu_torch import costmodel
from katib_tpu_torch.cli import main
from katib_tpu_torch.compile.registry import REGISTRY, CompileSignature, ShapeRegistry
from katib_tpu_torch.core.types import (
    ObjectiveSpec,
    ObjectiveType,
    ParameterAssignment,
    Trial,
    TrialCondition,
    TrialSpec,
)
from katib_tpu_torch.costmodel import counter
from katib_tpu_torch.costmodel import live as cm_live
from katib_tpu_torch.costmodel import peaks as cm_peaks
from katib_tpu_torch.costmodel.record import CostRecord
from katib_tpu_torch.models.data import synthetic_classification
from katib_tpu_torch.nas.darts.search import run_darts_search
from katib_tpu_torch.ops import flash_attention as fa
from katib_tpu_torch.ops import mixed_op
from katib_tpu_torch.runner.trial_runner import run_trial
from katib_tpu_torch.store.base import MemoryObservationStore
from katib_tpu_torch.utils import observability as obs
from tests.torch_compile_state import fresh_compile_state  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJECTIVE = ObjectiveSpec(type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy")

# the bounds PERF.md section 6 and chip_smoke.py divide by
HBM, BF16, F32 = 3.35e12, 989e12, 67e12


@pytest.fixture(autouse=True)
def clean_slot(monkeypatch):
    for name in cm_peaks.PEAK_ENV:
        monkeypatch.delenv(name, raising=False)
    cm_live.clear_active()
    cm_live._MEMO.clear()
    yield
    cm_live.clear_active()
    cm_live._MEMO.clear()


# -- the record ---------------------------------------------------------------

RECORDS = {
    "compute-bound": dict(program="p", flops=4e12, bytes_accessed=1e9, hbm_bytes=7, steps=4,
                          dtype="bf16"),
    "memory-bound": dict(program="q", flops=1e9, bytes_accessed=5e9, steps=1, dtype="f32"),
    "empty": dict(),
}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_record_matches_the_jax_record(name):
    fields = RECORDS[name]
    mine, theirs = CostRecord(**fields), JCostRecord(**fields)
    assert mine.as_dict() == theirs.as_dict()
    assert CostRecord.from_dict(theirs.as_dict()) == mine
    assert mine.flops_per_step == theirs.flops_per_step
    assert mine.arithmetic_intensity == theirs.arithmetic_intensity
    # the same peaks in both packages' classes give the same roofline and MFU
    pk = cm_peaks.DevicePeaks("k", {"bf16": 1e14, "f32": 5e13}, hbm_bandwidth=1e12)
    jpk = j_peaks.DevicePeaks("k", {"bf16": 1e14, "f32": 5e13}, hbm_bandwidth=1e12)
    assert mine.roofline(pk) == theirs.roofline(jpk)
    for secs in (0.0, 0.01, 2.5):
        assert mine.mfu(secs, pk) == theirs.mfu(secs, jpk)


def test_record_from_a_malformed_dict_is_the_default():
    assert CostRecord.from_dict({"flops": "x"}) == CostRecord()
    assert CostRecord.from_dict({"steps": 0}).steps == 1


# -- peaks --------------------------------------------------------------------


def test_the_table_holds_an_h100_row_and_the_cpu_row_only():
    assert sorted(cm_peaks.PEAKS) == ["cpu", "h100"]
    h100 = cm_peaks.PEAKS["h100"]
    assert h100.flops == {"bf16": BF16, "f32": F32}
    assert h100.hbm_bandwidth == HBM and h100.hbm_bytes == 80 * 1024**3
    assert h100.ridge_intensity == pytest.approx(BF16 / HBM)
    assert cm_peaks.PEAKS["cpu"] == cm_peaks.DevicePeaks(**vars(j_peaks.PEAKS["cpu"]))


@pytest.mark.parametrize("raw, key", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 SXM5 80GB", "h100"), ("h100", "h100"),
    ("cpu", "cpu"), ("CPU", "cpu"),
    ("NVIDIA H100 PCIe", "nvidia h100 pcie"), ("TPU v5 lite", "tpu v5 lite"), (None, ""),
])
def test_normalize_device_kind(raw, key):
    assert cm_peaks.normalize_device_kind(raw) == key


def test_detect_reads_the_given_device():
    assert cm_peaks.detect_device_kind("cpu") == "cpu"
    assert cm_peaks.detect_device_kind(torch.device("cpu")) == "cpu"


@pytest.mark.parametrize("kind", ["tpu v5 lite", "v5e", "nvidia h100 pcie", "a100"])
def test_an_unknown_kind_raises_naming_the_overrides(kind):
    with pytest.raises(cm_peaks.UnknownDevicePeaks, match="KATIB_PEAK_FLOPS.*KATIB_PEAK_BW"):
        cm_peaks.peaks_for(kind)


def test_overrides_apply_to_a_row_and_give_an_unknown_kind_its_peaks(monkeypatch):
    monkeypatch.setenv("KATIB_PEAK_FLOPS", "1e15")
    pk = cm_peaks.peaks_for("h100")
    assert pk.flops == {"bf16": 1e15, "f32": 1e15} and pk.hbm_bandwidth == HBM
    monkeypatch.setenv("KATIB_PEAK_BW", "2e12")
    other = cm_peaks.peaks_for("a100")
    assert (other.device_kind, other.peak_flops("f32"), other.hbm_bandwidth) == ("a100", 1e15, 2e12)
    monkeypatch.delenv("KATIB_PEAK_FLOPS")
    assert cm_peaks.peaks_for("a100").peak_flops() == 0.0


def test_peak_flops_falls_back_as_the_jax_row_does():
    pk = cm_peaks.DevicePeaks("x", {"f32": 5.0, "int8": 9.0})
    jpk = j_peaks.DevicePeaks("x", {"f32": 5.0, "int8": 9.0})
    for dtype in ("bf16", "f32", "int8", "f16"):
        assert pk.peak_flops(dtype) == jpk.peak_flops(dtype)


# -- the kernels' declared work -----------------------------------------------


def _bound_ms(flops: int, nbytes: int, flop_rate: float) -> float:
    return max(flops / flop_rate, nbytes / HBM) * 1e3


def test_mixed_op_declares_the_work_its_bound_uses():
    e, n_ops, m = 5, 8, 64 * 16 * 32 * 32  # PERF.md section 6, row 1, bf16
    flops, nbytes = mixed_op.mixed_op_work(e, n_ops, m, 2)
    assert flops == 2 * e * n_ops * m
    assert nbytes == (e * n_ops * m + e * m) * 2 + e * n_ops * 4
    assert round(nbytes / 1e6, 1) == 94.4
    assert round(_bound_ms(flops, nbytes, F32), 4) == 0.0282


@pytest.mark.parametrize("kernel, gflop, bound", [
    ("fwd", 68.7, 0.0695), ("dq", 103.1, 0.1043), ("dkv", 137.5, 0.1390),  # 137.47 GFLOP
])
def test_flash_kernels_declare_the_work_their_bounds_use(kernel, gflop, bound):
    b, h, s, d = 4, 8, 4096, 64  # models/transformer.py::LONG_CONTEXT, bf16 causal
    flops, nbytes = fa.flash_work(kernel, (b, h, s, d), s, True, 2)
    pairs = b * h * s * (s + 1) // 2
    n, rows = b * h * s * d, b * h * s
    want = {"fwd": (2 * 2 * d * pairs, 4 * n * 2 + 4 * rows),
            "dq": (3 * 2 * d * pairs, 5 * n * 2 + 2 * 4 * rows),
            "dkv": (4 * 2 * d * pairs, 6 * n * 2 + 2 * 4 * rows)}[kernel]
    assert (flops, nbytes) == want
    assert round(flops / 1e9, 1) == gflop
    assert round(_bound_ms(flops, nbytes, BF16), 4) == bound


@pytest.mark.parametrize("sq, sk", [(1, 1), (5, 5), (3, 7), (7, 3), (8, 1), (1, 9), (16, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_visible_pairs_count_the_mask(sq, sk, causal):
    mask = fa._causal_mask(sq, sk, "cpu") if causal else torch.ones(sq, sk, dtype=torch.bool)
    assert fa.visible_pairs(sq, sk, causal) == int(mask.sum())


def _count(fn, *args):
    return counter.count_step(lambda a: fn(*a), lambda: args, torch.device("cpu"))


def test_a_mixed_op_call_counts_its_declared_work_once_and_not_its_plain_version():
    g = torch.Generator().manual_seed(0)
    w = torch.softmax(torch.randn(5, 8, generator=g), -1)
    x = torch.randn(5, 8, 300, generator=g).to(torch.bfloat16)
    c = _count(mixed_op.mixed_op_sum, w, x)
    assert (c.flops, c.bytes_accessed) == mixed_op.mixed_op_work(5, 8, 300, 2)
    assert (c.kernel_flops, c.kernel_bytes) == (c.flops, c.bytes_accessed)
    assert c.launches == {"mixed_op": 1} and c.aten_calls == 0


def test_a_flash_step_counts_each_kernel_once_and_the_delta_as_aten_calls():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 64, 32, generator=g).requires_grad_() for _ in range(3))

    def step(q, k, v):
        return torch.autograd.grad(fa.flash_attention(q, k, v, causal=True).sum(), (q, k, v))

    c = _count(step, q, k, v)
    assert c.launches == {f"flash_attention_{n}": 1 for n in ("fwd", "dq", "dkv")}
    want = [fa.flash_work(n, (1, 2, 64, 32), 64, True, 4) for n in ("fwd", "dq", "dkv")]
    assert c.kernel_flops == sum(f for f, _ in want)
    assert c.kernel_bytes == sum(b for _, b in want)
    # the backward's delta term (rowsum(dO * O)) and the loss's sum are aten calls
    assert c.flops > c.kernel_flops and c.aten_calls > 0


# -- the count ----------------------------------------------------------------


def test_count_formulas_for_products_elementwise_and_reductions():
    x, w = torch.randn(8, 16), torch.randn(16, 4)
    c = _count(lambda a, b: torch.tanh(a @ b).sum(), x, w)
    assert c.flops == 2 * 8 * 16 * 4 + 8 * 4 + 8 * 4  # mm, tanh, sum
    assert c.bytes_accessed == (8 * 16 + 16 * 4 + 8 * 4) * 4 + (8 * 4 * 2) * 4 + (8 * 4 + 1) * 4
    conv_x, conv_w = torch.randn(2, 6, 5, 5), torch.randn(6, 2, 3, 3)  # groups=3
    c = _count(lambda a, b: torch.nn.functional.conv2d(a, b, padding=1, groups=3), conv_x, conv_w)
    assert c.flops == 2 * 5 * 5 * 3 * 3 * 2 * 6 * 2  # out positions x taps x batch x c_out x c_in/g


def test_views_move_no_bytes_and_the_count_never_syncs(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a count synchronized the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    c = _count(lambda a: a.t()[1:3].unsqueeze(0).expand(2, 2, 4), torch.randn(4, 4))
    assert (c.flops, c.bytes_accessed, c.aten_calls) == (0, 0, 0)
    c = _count(lambda a: a.t().clone(), torch.randn(4, 4))  # a copy: bytes, no flops
    assert (c.flops, c.bytes_accessed) == (0, 2 * 16 * 4)


def test_product_formulas_match_flop_counter_and_no_footprint_is_read():
    """The count passes shapes to flop_counter's formulas itself: the same
    products as ``FlopCounterMode`` (a grouped convolution's backward and
    batched products included); ``hbm_bytes`` is not read."""
    from torch.utils.flop_counter import FlopCounterMode

    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 6, 5, 5, generator=g, requires_grad=True)
    w = torch.randn(6, 2, 3, 3, generator=g, requires_grad=True)
    a, b = torch.randn(3, 4, 5, generator=g), torch.randn(3, 5, 2, generator=g)
    bias, m = torch.randn(4, 2, generator=g), torch.randn(5, 2, generator=g)

    def step(args):
        y = torch.nn.functional.conv2d(args[0], args[1], padding=1, groups=3)
        torch.ops.aten.convolution_backward(torch.ones_like(y), args[0], args[1], None, [1, 1],
                                            [1, 1], [1, 1], False, [0, 0], 3, [True, True, False])
        return torch.bmm(a, b), torch.addmm(bias, a[0], m)

    with FlopCounterMode(display=False) as ref:
        step((x, w))
    c = counter.count_step(step, lambda: (x, w), torch.device("cpu"))
    assert c.flops == ref.get_total_flops() > 0
    assert c.hbm_bytes == 0


def test_a_count_imports_neither_dynamo_nor_sympy():
    """What a first count imports beyond ``import torch``: no Dynamo, no
    sympy, no fake or meta tensor machinery (seconds on a card's host)."""
    code = textwrap.dedent("""
        import sys, torch
        from katib_tpu_torch.costmodel import counter
        x = torch.randn(8, 8, requires_grad=True)
        before = set(sys.modules)
        counter.count_step(lambda a: torch.autograd.grad((a[0] @ a[0]).relu().sum(), a[0]),
                           lambda: (x,), torch.device("cpu"))
        print(sorted(m for m in set(sys.modules) - before
                     if m.startswith(("sympy", "torch._dynamo", "torch._subclasses"))))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- the live slot ------------------------------------------------------------


class _Counts:
    def __init__(self, flops=10.0):
        self.calls, self.flops = 0, flops

    def __call__(self):
        self.calls += 1
        return counter.StepCount(flops=self.flops, bytes_accessed=5.0, seconds=0.25)


def test_observe_arms_the_slot_and_memoizes():
    count = _Counts()
    rec = cm_live.observe_program(("prog", 8), count, program="p", per_report=3, device="cpu")
    assert rec == CostRecord(program="p", flops=10.0, bytes_accessed=5.0)
    assert cm_live.active_cost() == (rec, 3)
    assert cm_live.observe_program(("prog", 8), count, program="p", per_report=3) == rec
    assert count.calls == 1
    assert cm_live.take_count_seconds() == 0.25 and cm_live.take_count_seconds() == 0.0


@pytest.mark.parametrize("label", [None, ["unhashable"]])
def test_none_and_unhashable_labels_skip_the_memo(label):
    count = _Counts()
    cm_live.observe_program(label, count, program="p")
    cm_live.observe_program(label, count, program="p")
    assert count.calls == 2


def test_a_failed_count_is_logged_pinned_and_arms_nothing(caplog):
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("no")

    with caplog.at_level(logging.WARNING):
        assert cm_live.observe_program(("broken",), broken, program="b") is None
        assert cm_live.observe_program(("broken",), broken, program="b") is None
    assert len(calls) == 1 and cm_live.active_cost() is None
    assert "cost count of b failed" in caplog.text


def test_a_label_being_counted_is_waited_for_not_counted_again():
    """Two trials of one step structure at once: the second waits for the
    first's count and adopts its record."""
    started, release = threading.Event(), threading.Event()
    calls = []

    def slow():
        calls.append(1)
        started.set()
        release.wait(10)
        return counter.StepCount(flops=3.0, bytes_accessed=1.0, seconds=0.1)

    got = []
    first = threading.Thread(target=lambda: got.append(
        cm_live.observe_program(("inflight",), slow, program="p")))
    first.start()
    assert started.wait(10)
    second = threading.Thread(target=lambda: got.append(
        (cm_live.observe_program(("inflight",), slow, program="p"),
         cm_live.take_count_seconds())))
    second.start()
    time.sleep(0.2)
    assert second.is_alive()  # waiting on the first count
    release.set()
    first.join(10)
    second.join(10)
    rec, waited = got[1]
    assert calls == [1] and rec == got[0] == CostRecord(program="p", flops=3.0, bytes_accessed=1.0)
    assert waited >= 0.15  # the wait leaves the second trial's report interval
    assert not cm_live._IN_FLIGHT


def test_a_darts_sweep_over_rates_counts_its_step_once(fresh_compile_state):
    """The DARTS step's label is what shapes the work: trials that differ
    only in learning rates, momentum, decays or the clip adopt one count."""
    from katib_tpu_torch.nas.darts.architect import DartsHyper

    ds = synthetic_classification(16, 8, (32, 32, 3), 10, seed=7)
    kw = dict(num_layers=2, init_channels=4, n_nodes=4, batch_size=8, num_epochs=1,
              step_loop=False, remat=False, seed=0, device="cpu", report=lambda **_: True)
    counts = []
    for hyper in (DartsHyper(), DartsHyper(w_lr=0.1, w_momentum=0.5, w_weight_decay=0.0,
                                           w_grad_clip=1.0, alpha_lr=1e-2,
                                           alpha_weight_decay=0.0),
                  DartsHyper(unrolled=False)):
        run_darts_search(ds, hyper=hyper, **kw)
        counts.append(cm_live.active_count())
    assert counts[0] is counts[1] and counts[0].flops > 0
    assert counts[2] is not counts[0] and counts[2].flops < counts[0].flops  # first order


def test_the_memo_is_bounded():
    for i in range(cm_live._MEMO_MAX + 5):
        cm_live.observe_program(("m", i), _Counts(), program="p")
    assert len(cm_live._MEMO) == cm_live._MEMO_MAX


def test_a_registry_row_of_the_signature_is_adopted_instead_of_a_count(fresh_compile_state):
    sig = CompileSignature(program="adopted", shapes=(("units", "8"),))
    REGISTRY.record_cost(sig, CostRecord(program="train_classifier.step", flops=7.0).as_dict())
    cm_live.set_signature(sig)
    count = _Counts()
    rec = cm_live.observe_program(("a",), count, program="train_classifier.step")
    assert count.calls == 0 and rec.flops == 7.0
    # a row of another program is not adopted: counted, and the row updated
    rec = cm_live.observe_program(("b",), count, program="other")
    assert count.calls == 1 and REGISTRY.cost_of(sig)["program"] == "other"


def test_clear_active_disarms():
    cm_live.set_active_cost(CostRecord(flops=1.0), per_report=2)
    cm_live.set_signature(CompileSignature(program="x"))
    cm_live.clear_active()
    assert cm_live.active_cost() is None and cm_live.span_attrs() == {}
    assert cm_live._registry_cost("x") is None


def test_publish_sets_the_gauges_and_attrs():
    pk = cm_peaks.DevicePeaks("testkind", {"bf16": 100.0}, hbm_bandwidth=10.0)
    rec = CostRecord(program="p", flops=50.0, bytes_accessed=1.0)
    attrs = cm_live.publish_dispatch(rec, 1.0, workload="wl-publish", peaks=pk)
    assert attrs == {"mfu": 0.5, "arithmetic_intensity": 50.0, "roofline": "compute-bound",
                     "roofline_headroom": 2.0}
    assert cm_live.span_attrs() == attrs
    assert obs.dispatch_mfu.get(workload="wl-publish", device_kind="testkind",
                                dtype="bf16") == pytest.approx(0.5)
    assert obs.arithmetic_intensity.get(workload="wl-publish") == 50.0
    assert obs.roofline_headroom.get(workload="wl-publish",
                                     bound="compute-bound") == pytest.approx(2.0)


def test_publish_divides_by_the_slot_devices_peaks():
    rec = CostRecord(program="p", flops=2e11, dtype="f32")
    cm_live.set_active_cost(rec, device="cpu")
    attrs = cm_live.publish_dispatch(rec, 1.0, workload="wl-cpu")
    assert attrs["mfu"] == 1.0  # the cpu row's nominal 2e11 flop/s


def test_publish_rejects_zero_time_and_zero_flops():
    assert cm_live.publish_dispatch(CostRecord(flops=1.0), 0.0, workload="x") == {}
    assert cm_live.publish_dispatch(CostRecord(flops=0.0), 1.0, workload="x") == {}


def test_an_unknown_device_publishes_nothing_and_warns_once(monkeypatch, caplog):
    monkeypatch.setattr(cm_peaks, "detect_device_kind", lambda device=None: "a100")
    monkeypatch.setattr(cm_live, "detect_device_kind", lambda device=None: "a100")
    monkeypatch.setattr(cm_live, "_WARNED_KINDS", set())
    rec = CostRecord(program="p", flops=1e9)
    with caplog.at_level(logging.WARNING):
        assert cm_live.publish_dispatch(rec, 1.0, workload="wl-unknown") == {}
        assert cm_live.publish_dispatch(rec, 1.0, workload="wl-unknown") == {}
    assert caplog.text.count("a100") == 1 and "KATIB_PEAK_BW" in caplog.text
    assert not [v for labels, v in obs.dispatch_mfu.samples()
                if labels.get("workload") == "wl-unknown"]


# -- registry cost rows --------------------------------------------------------


def test_record_cost_is_idempotent_and_readable():
    reg = ShapeRegistry()
    sig = CompileSignature(program="cost_prog", k=2)
    cost = CostRecord(program="cost_prog", flops=9.0).as_dict()
    assert reg.record_cost(sig, cost) is True
    assert reg.record_cost(sig, cost) is False
    assert reg.cost_of(sig) == cost
    rows = [r for r in reg.signatures() if r["program"] == "cost_prog"]
    assert rows and rows[0]["source"] == "cost"
    assert reg.cost_of(CompileSignature(program="other")) is None


def test_cost_persists_reloads_and_survives_a_later_row(tmp_path, fresh_compile_state):
    from katib_tpu_torch.compile import registry as regmod
    from katib_tpu_torch.runner.trial_runner import init_compile_cache

    init_compile_cache(str(tmp_path))
    sig = CompileSignature(program="persist_prog", k=1)
    REGISTRY.record(sig, source="trial", compile_seconds=0.1)
    cost = CostRecord(program="persist_prog", flops=3.0, steps=2).as_dict()
    assert REGISTRY.record_cost(sig, cost) is True
    path = tmp_path / "torch" / "shape_registry.jsonl"
    lines = path.read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[-1])["cost"] == cost
    fresh = ShapeRegistry()
    assert fresh.cost_of(sig) == cost
    assert [r for r in fresh.signatures() if r["program"] == "persist_prog"][0]["source"] == "trial"
    # a later row of the key without a cost (another process warming it)
    # keeps the cost, on reload and for the verbs' reader
    with open(path, "a") as f:
        f.write(json.dumps({"key": sig.key(), "program": "persist_prog", "k": 1,
                            "source": "prewarm"}) + "\n")
    assert ShapeRegistry().cost_of(sig) == cost
    assert [r["cost"] for r in regmod.read_rows(str(tmp_path))] == [cost]


# -- the heartbeat seam ------------------------------------------------------


def _trial(name, train_fn, **params):
    assignments = [ParameterAssignment(k, v) for k, v in (params or {"x": 1.0}).items()]
    return Trial(name=name, spec=TrialSpec(assignments=assignments, train_fn=train_fn))


def test_run_trial_publishes_mfu_and_persists_cost(fresh_compile_state):
    def costed_trainer(ctx):
        costmodel.set_active_cost(CostRecord(program="costed_trainer", flops=1e9),
                                  per_report=1, device="cpu")
        for step in range(3):
            time.sleep(0.01)
            if not ctx.report(accuracy=0.5 + step / 10, step=step):
                return

    res = run_trial(_trial("cost-t1", costed_trainer), MemoryObservationStore(), OBJECTIVE,
                    device="cpu")
    assert res.condition == TrialCondition.SUCCEEDED
    mine = [v for labels, v in obs.dispatch_mfu.samples()
            if labels.get("workload", "").endswith("costed_trainer")]
    assert mine and mine[0] > 0
    rows = [r for r in REGISTRY.signatures() if r["program"].endswith("costed_trainer")]
    assert rows and rows[0]["cost"]["flops"] == 1e9


def test_executor_thread_reuse_does_not_leak_cost(fresh_compile_state):
    seen = []

    def costed(ctx):
        costmodel.set_active_cost(CostRecord(flops=1.0), device="cpu")
        ctx.report(accuracy=1.0, step=0)

    def plain(ctx):
        seen.append(costmodel.active_cost())
        ctx.report(accuracy=1.0, step=0)

    with ThreadPoolExecutor(max_workers=1) as pool:  # one thread runs both trials
        for name, fn in (("leak-a", costed), ("leak-b", plain)):
            res = pool.submit(run_trial, _trial(name, fn), MemoryObservationStore(), OBJECTIVE,
                              device="cpu").result()
            assert res.condition == TrialCondition.SUCCEEDED
    assert seen == [None]


def test_mnist_trial_counts_its_step_and_publishes_on_every_later_heartbeat(
        tmp_path, fresh_compile_state):
    from katib_tpu_torch.models.mnist import mnist_trial
    from katib_tpu_torch.runner.trial_runner import init_compile_cache
    from katib_tpu_torch.utils import tracing

    init_compile_cache(str(tmp_path))
    trial = _trial("mnist-cost", mnist_trial, arch="mlp", units=16, n_train=256, n_test=64,
                   epochs=3, batch_size=64)
    tracer = tracing.Tracer(str(tmp_path / "trace.jsonl"))
    with tracing.use_tracer(tracer):
        res = run_trial(trial, MemoryObservationStore(), OBJECTIVE, device="cpu")
    tracer.close()
    assert res.condition == TrialCondition.SUCCEEDED
    count = cm_live.active_count()
    # one MLP step: 784 -> 16 -> 16 -> 10 at batch 64, forward and backward
    products = 2 * 64 * (784 * 16 + 16 * 16 + 16 * 10)
    # the backward needs no input gradient: a product of each layer forward, two
    # backward but the first layer's one, plus the elementwise calls
    assert count.kernel_flops == 0 and 2 * products <= count.flops <= 3 * products
    cost = REGISTRY.cost_of(CompileSignature(
        program="mnist_trial", shapes=tuple(sorted(
            (k, str(v)) for k, v in trial.params().items() if not isinstance(v, float)))))
    assert cost == count.record("train_classifier.step", dtype="bf16").as_dict()
    assert obs.dispatch_mfu.get(workload="mnist_trial", device_kind="cpu", dtype="bf16") > 0
    spans = [json.loads(line) for line in open(tmp_path / "trace.jsonl")]
    (train_fn,) = [s for s in spans if s["name"] == "train_fn"]
    assert train_fn["args"]["mfu"] > 0 and train_fn["args"]["roofline"].endswith("-bound")


def test_the_count_seconds_leave_the_heartbeat_interval(monkeypatch, fresh_compile_state):
    published = []
    monkeypatch.setattr(cm_live, "publish_dispatch",
                        lambda rec, secs, **kw: published.append(secs) or {})

    def slow_count(ctx):
        ctx.report(accuracy=0.1, step=0)
        cm_live.observe_program(None, lambda: (time.sleep(0.3), counter.StepCount(
            flops=1.0, seconds=0.3))[1], program="slow", device="cpu")
        ctx.report(accuracy=0.2, step=1)

    run_trial(_trial("slow-count", slow_count), MemoryObservationStore(), OBJECTIVE, device="cpu")
    assert len(published) == 1 and published[0] < 0.2


def test_a_cohort_publishes_its_programs_mfu_on_every_later_heartbeat(fresh_compile_state):
    from katib_tpu_torch.compile.registry import cohort_signature
    from katib_tpu_torch.models.mnist import mnist_cohort_trial
    from katib_tpu_torch.runner.cohort import run_cohort
    from tests.test_torch_cohort import _mnist_trial

    trials = [_mnist_trial(f"cost-c{i}", 0.01 * (i + 1), units=8, epochs=3) for i in range(4)]
    results = run_cohort(trials, MemoryObservationStore(), OBJECTIVE, device="cpu")
    assert all(r.condition is TrialCondition.SUCCEEDED for r in results.values())
    count = cm_live.active_count()
    assert count is not None and count.flops > 0 and count.kernel_flops == 0
    assert obs.dispatch_mfu.get(workload="mnist_cohort_trial", device_kind="cpu",
                                dtype="bf16") > 0
    cost = REGISTRY.cost_of(cohort_signature(mnist_cohort_trial, trials, 4))
    assert cost == count.record("mnist_cohort_trial.step").as_dict()


def test_a_pbt_generation_count_folds_its_steps_and_changes_nothing():
    from tests.test_torch_pbt_ondevice import _digits_population, _port_generation

    lrs = [0.01, 0.05, 0.1, 0.3]
    ds, stacked = _digits_population(4, lrs)
    gen = _port_generation(ds, stacked, lrs, 0.25)
    before = [t.clone() for t in (*gen.states.params.values(), *gen.hypers.values())]
    count = gen.count_generation(torch.Generator().manual_seed(0))
    step = gen.loop.count_step()
    # five train steps, then the eval, the selection and the clone
    assert count.flops > 5 * step.flops > 0 and count.aten_calls > 5 * step.aten_calls
    after = [*gen.states.params.values(), *gen.hypers.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after, strict=True))


# -- the cost verb and trace summary -----------------------------------------


def _cost_row(program="tbl_prog", k=2, **cost):
    sig = CompileSignature(program=program, k=k)
    fields = dict(program=program, flops=2e9, bytes_accessed=1e8, steps=2, hbm_bytes=2**30)
    fields.update(cost)
    return {"key": sig.key(), "program": program, "k": k, "mesh": "", "shapes": {},
            "donation": True, "source": "trial", "cost": CostRecord(**fields).as_dict()}


def test_cost_of_an_empty_dir_exits_1(tmp_path, capsys):
    assert main(["cost", str(tmp_path)]) == 1
    assert "no cost records" in capsys.readouterr().err


@pytest.mark.parametrize("layout", ["cache", "torch", "workdir"])
def test_cost_of_a_registry_dir_prints_the_table(tmp_path, capsys, layout):
    where = {"cache": tmp_path / "torch", "torch": tmp_path / "torch",
             "workdir": tmp_path / "run" / "torch"}[layout]
    where.mkdir(parents=True)
    (where / "shape_registry.jsonl").write_text(json.dumps(_cost_row()) + "\n")
    target = {"cache": tmp_path, "torch": tmp_path / "torch", "workdir": tmp_path}[layout]
    assert main(["cost", str(target), "--device", "h100"]) == 0
    out = capsys.readouterr().out
    assert "roofline vs h100: 989.0 TFLOP/s bf16 peak, 3350 GB/s" in out
    (row,) = [line.split() for line in out.splitlines() if line.startswith("tbl_prog")]
    # 1 GFLOP and 50 MB a step: memory-bound at 20 flops/byte, floor 50e6/3.35e12 s
    assert row == ["tbl_prog", "2", "-", "1.000", "50.00", "20.0", "memory", "0.015", "0.07",
                   "1.00"]


def test_cost_refuses_a_device_without_peaks(tmp_path, capsys):
    assert main(["cost", str(tmp_path), "--device", "v5e"]) == 2
    assert "KATIB_PEAK_FLOPS" in capsys.readouterr().err


def _mnist_cost_spec(tmp_path):
    spec = tmp_path / "mnist.yaml"
    spec.write_text(textwrap.dedent(f"""\
        apiVersion: kubeflow.org/v1beta1
        kind: Experiment
        metadata: {{name: cost-mnist}}
        spec:
          objective: {{type: maximize, objectiveMetricName: accuracy}}
          algorithm: {{algorithmName: random}}
          maxTrialCount: 1
          compileCache: {tmp_path / "cache"}
          parameters:
            - name: lr
              parameterType: double
              feasibleSpace: {{min: "0.01", max: "0.1"}}
            - name: arch
              parameterType: categorical
              feasibleSpace: {{list: [mlp]}}
            - name: n_train
              parameterType: int
              feasibleSpace: {{min: "256", max: "256"}}
            - name: batch_size
              parameterType: int
              feasibleSpace: {{min: "64", max: "64"}}
          trialTemplate:
            trainFn: katib_tpu.models.mnist.mnist_trial
    """))
    return spec


def test_cost_of_a_spec_runs_its_prewarm_twin_on_the_cpu(tmp_path, capsys, fresh_compile_state):
    spec = _mnist_cost_spec(tmp_path)
    assert main(["cost", str(spec), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "roofline vs cpu" in out and "mnist_trial" in out
    # the row is on file: the directory form prints it too
    assert main(["cost", str(tmp_path / "cache")]) == 0
    assert "mnist_trial" in capsys.readouterr().out


def test_cost_of_a_spec_runs_its_twins_on_the_card_unless_asked(tmp_path, capsys, monkeypatch,
                                                                fresh_compile_state):
    """Without ``--device`` the twins run where every entry point runs (the
    card); with no card that is an error, not a CPU run under the card's
    name."""
    import katib_tpu_torch.device as device_mod

    spec = _mnist_cost_spec(tmp_path)
    if not torch.cuda.is_available():
        assert main(["cost", str(spec)]) == 2
        assert "no CUDA GPU" in capsys.readouterr().err
    asked = []

    def resolve(device=None):
        asked.append(device)
        return torch.device("cpu")  # stands in for the card here

    monkeypatch.setattr(device_mod, "resolve_device", resolve)
    assert main(["cost", str(spec)]) == 0
    assert asked == [None] and "roofline vs cpu" in capsys.readouterr().out
    assert main(["cost", str(spec), "--device", "h100"]) == 0  # costed: the twins do not rerun
    assert asked == [None, None] and "roofline vs h100" in capsys.readouterr().out


def test_trace_summary_top_shows_the_ports_mfu(tmp_path, capsys, fresh_compile_state):
    from katib_tpu_torch.core.types import (
        AlgorithmSpec,
        ExperimentSpec,
        FeasibleSpace,
        ParameterSpec,
        ParameterType,
    )
    from katib_tpu_torch.models.mnist import mnist_trial
    from katib_tpu_torch.orchestrator.orchestrator import Orchestrator

    spec = ExperimentSpec(
        name="cost-top", objective=OBJECTIVE, algorithm=AlgorithmSpec("grid"),
        parameters=[
            ParameterSpec("units", ParameterType.CATEGORICAL, FeasibleSpace(list=["16"])),
            ParameterSpec("n_train", ParameterType.CATEGORICAL, FeasibleSpace(list=["256"])),
            ParameterSpec("epochs", ParameterType.CATEGORICAL, FeasibleSpace(list=["3"])),
            ParameterSpec("batch_size", ParameterType.CATEGORICAL, FeasibleSpace(list=["64"])),
        ],
        max_trial_count=1, parallel_trial_count=1, train_fn=mnist_trial, prewarm=False,
    )
    exp = Orchestrator(workdir=str(tmp_path), device="cpu").run(spec)
    assert all(t.condition == TrialCondition.SUCCEEDED for t in exp.trials.values())
    capsys.readouterr()
    assert main(["trace", "summary", "cost-top", "--workdir", str(tmp_path), "--top", "40"]) == 0
    out = capsys.readouterr().out
    rows = [line.split() for line in out.split("slowest")[1].splitlines()[2:] if line.strip()]
    trial_rows = [r for r in rows if r[0] in ("trial", "train_fn")]
    assert len(trial_rows) == 2
    for r in trial_rows:
        assert float(r[3]) > 0 and r[4].endswith("-bound")


def test_profile_and_enable_profiler_name_item_8c(capsys, tmp_path):
    """Item 8c is ported: ``profile`` with neither ``--list`` nor a YAML is
    the JAX verb's usage error (exit 2), and ``enable_profiler`` traces the
    trial into ``<checkpoint_dir>/profile`` (``tests/test_torch_profiler.py``
    holds both against the JAX package)."""
    assert main(["profile"]) == 2
    assert "--list" in capsys.readouterr().err
    from katib_tpu_torch.core.config import KatibConfig
    from katib_tpu_torch.core.types import (
        AlgorithmSpec,
        ExperimentSpec,
        FeasibleSpace,
        ParameterSpec,
        ParameterType,
    )
    from katib_tpu_torch.orchestrator.orchestrator import Orchestrator

    def trainer(ctx):
        ctx.report(step=0, accuracy=float(torch.ones(2).sum()))

    spec = ExperimentSpec(
        name="prof", algorithm=AlgorithmSpec(name="grid"),
        objective=ObjectiveSpec(type=ObjectiveType.MAXIMIZE, objective_metric_name="accuracy"),
        parameters=[ParameterSpec("x", ParameterType.CATEGORICAL, FeasibleSpace(list=["1"]))],
        max_trial_count=1, parallel_trial_count=1, train_fn=trainer,
    )
    orch = Orchestrator(workdir=str(tmp_path), device="cpu", config=KatibConfig.from_dict(
        {"init": {"enable_profiler": True}}))
    (trial,) = orch.run(spec).trials.values()
    assert trial.condition == TrialCondition.SUCCEEDED, trial.message
    assert os.path.isfile(os.path.join(trial.checkpoint_dir, "profile", "trace.json"))

