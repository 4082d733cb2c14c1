"""Cohort shape bucketing: quantize cohort width K onto few padded sizes
(copy of ``katib_tpu/compile/buckets.py``).

Every distinct stacked leading dimension K is a distinct program — in the
port a distinct captured CUDA graph, and in the JAX package a distinct XLA
executable.  Rounding K up to the next power of two collapses cohorts of
K=7, K=5, K=3 onto few widths: the extra rows are inert ghost members (they
train on member 0's hyperparameters and their metric rows never reach the
store — ``runner/cohort.py``), so the padding costs work that was already
idle, not correctness.

A sharded cohort must carry a member count divisible by the trial-axis
size D, so a bucket is the power of two rounded up to a multiple of D.
The port has no trial-axis mesh yet: :func:`bucketed_cohort_size` raises
for a mesh.
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (1 for n <= 1)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def bucket_size(k: int, multiple: int = 1) -> int:
    """The padded bucket for a K-member cohort: next power of two, then
    rounded up to a multiple of ``multiple`` (the trial-axis size)."""
    if k < 1:
        raise ValueError(f"cohort width must be >= 1, got {k}")
    m = max(int(multiple), 1)
    b = next_pow2(k)
    return -(-b // m) * m


def bucketed_cohort_size(k: int, mesh=None) -> int:
    """Mesh-aware :func:`bucket_size`; the port runs a cohort on one
    device, so a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            "a cohort over a trial-axis mesh (katib_tpu/parallel/mesh.py), not ported yet "
            "(ROADMAP item 9b)"
        )
    return bucket_size(k)


def bucket_table(max_k: int, multiple: int = 1) -> list[tuple[int, int]]:
    """The K -> bucket mapping for widths 1..max_k (docs/tests/CLI view)."""
    return [(k, bucket_size(k, multiple)) for k in range(1, max_k + 1)]


def prewarm_widths(
    max_width: int, buckets: bool = True, multiple: int = 1
) -> list[int]:
    """Every padded width the orchestrator's grouping can produce for a
    sweep with ``cohortWidth = max_width``: the singleton program plus the
    (bucketed) cohort sizes 2..max_width.  The width set the ``prewarm``
    verb warms."""
    widths = {1}
    for size in range(2, max(1, int(max_width)) + 1):
        widths.add(bucket_size(size, multiple) if buckets else size)
    return sorted(widths)
