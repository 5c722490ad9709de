"""Shared fixtures: one smoke GQA model + its single-engine greedy
reference, session-scoped so the runtime and paged-engine tests stop
re-initialising params per module."""
import pytest

import jax


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long end-to-end tests (multi-process workers); "
                   "deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels of the torch "
                   "port); skips without one")

from repro.models import init

from harness import EC, f32, random_prompts, reference_outputs


@pytest.fixture(scope="session")
def gqa_model():
    from repro.configs import get_smoke_config
    cfg = f32(get_smoke_config("smollm_360m"))
    return cfg, init(cfg, jax.random.key(0))


@pytest.fixture(scope="session")
def reference(gqa_model):
    """Prompts + greedy outputs from a single full-model dense engine."""
    cfg, params = gqa_model
    prompts = random_prompts(cfg, (10, 5, 16, 12), seed=0)
    return prompts, reference_outputs(cfg, params, prompts, ec=EC,
                                      max_new_tokens=6)
