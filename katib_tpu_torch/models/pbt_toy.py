"""Toy PBT benchmark workload — parity with the reference's ``simple-pbt``
trial image (``examples/v1beta1/trial-images/simple-pbt/pbt_test.py:31-127``).

Port of ``katib_tpu/models/pbt_toy.py``.  The optimal learning rate follows a
triangle wave over global steps, so no fixed lr wins: a population must
*exploit* (clone a leader's checkpoint) and *explore* (perturb lr) to track
the moving optimum.  The reference persists a pickle in the PVC-mounted
``--checkpoint`` dir and sleeps ≥7s for sidecar PID-scan latency; here state
is a ``torch.save`` step in the trial's checkpoint directory
(``utils/checkpoint.py``) and metrics stream in-process — no sleeps, no
sidecar.

The state is two 0-d tensors on the trial's device (``cuda`` unless the
caller names the CPU), with the JAX trial's dtypes: an int32 ``step`` and a
float32 ``score``.  So a resumed score is rounded to float32 exactly as the
JAX trial's is.
"""

from __future__ import annotations

import torch

from katib_tpu_torch.device import resolve_device


def optimal_lr(step: int, period: int = 20, peak: float = 0.1) -> float:
    """Triangle wave in [0, peak] with the given period."""
    phase = (step % period) / (period / 2.0)
    return peak * (1.0 - abs(phase - 1.0))


def pbt_toy_trial(ctx) -> None:
    """Score accrues per step by how close this member's lr is to the moving
    optimum; lineage continues from the (possibly inherited) checkpoint."""
    device = resolve_device(ctx.device)
    lr = float(ctx.params["lr"])
    steps_per_round = int(ctx.params.get("steps_per_round", 4))

    restored = ctx.restore_checkpoint()
    if restored is not None:
        state, _ = restored
        score = float(state["score"])
        start = int(state["step"]) + 1
    else:
        score, start = 0.0, 0

    for step in range(start, start + steps_per_round):
        opt = optimal_lr(step)
        score += max(0.0, 0.02 - abs(lr - opt))
        if not ctx.report(step=step, score=score, lr_gap=abs(lr - opt)):
            break

    ctx.save_checkpoint(
        {
            "step": torch.tensor(step, dtype=torch.int32, device=device),
            "score": torch.tensor(score, dtype=torch.float32, device=device),
        },
        step,
    )
