"""A fixture for the port's tests that wire a compile cache or an artifact
tier: both are process-global (the first caller wins), so each such test
starts from none and leaves none behind."""

from __future__ import annotations

import pytest


@pytest.fixture
def fresh_compile_state(monkeypatch):
    """No compile cache, no shared artifact tier, an empty shape registry;
    the same again after the test."""
    from katib_tpu_torch.compile import artifacts, registry

    monkeypatch.delenv("KATIB_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("KATIB_ARTIFACT_DIR", raising=False)
    monkeypatch.setattr(registry, "_CACHE_ROOT", None)
    registry.REGISTRY.reset()
    artifacts.ARTIFACTS.reset()
    yield monkeypatch
    registry.REGISTRY.reset()
    artifacts.ARTIFACTS.reset()
