"""Test config: force an 8-device virtual CPU platform before jax imports.

Distributed logic (pipeline stages, TP shardings, collectives) is tested on
a host-simulated mesh per SURVEY.md §4's implication — no pod required.
"""

import os

# Force-override: the session env pins JAX_PLATFORMS to the real accelerator;
# tests always run on the virtual CPU mesh. CAKE_TESTS_TPU=1 keeps the real
# accelerator instead: single-device test files then exercise the REAL Pallas
# kernels (interpret=False) on silicon — the on-chip validation lane for
# ops/flash_attention.py and ops/int4_matmul.py (multi-device mesh tests
# still need the CPU lane; run them separately).
_ON_TPU = os.environ.get("CAKE_TESTS_TPU") == "1"
if not _ON_TPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
# Arm the cakelint thread-affinity runtime asserts for the whole suite
# (cake_tpu/analysis/annotations.py): @engine_thread_only methods raise
# WrongThreadError on a cross-thread call while the engine thread is
# alive. MUST be set before any cake_tpu import — the decorator reads
# the flag once, at decoration time, so production (flag unset) pays
# zero wrapper cost.
os.environ.setdefault("CAKE_THREAD_ASSERTS", "1")
# hermetic: never attempt HF-hub downloads from tests (zero-egress CI
# would stall through network retries); cache hits still resolve
os.environ.setdefault("HF_HUB_OFFLINE", "1")
# Golden tests compare f32 logits against torch; XLA:CPU otherwise lowers
# f32 matmuls to bf16-ish oneDNN paths (~1e-3 error).
os.environ["JAX_DEFAULT_MATMUL_PRECISION"] = "highest"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Something in the test environment imports jax before conftest runs, so the
# env vars alone may be read too late — set the config directly as well
# (safe as long as no backend has been initialised yet).
if not _ON_TPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-second cases (2-process serving, big meshes); "
        "deselect with -m 'not slow' for the fast lane")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the port's CUDA kernels); skips "
        "where torch.cuda.is_available() is False")


@pytest.fixture(scope="session")
def tiny_config():
    from cake_tpu.models.llama.config import LlamaConfig
    return LlamaConfig.tiny()


@pytest.fixture(scope="session")
def tiny_params(tiny_config):
    import jax
    from cake_tpu.models.llama.params import init_params
    return init_params(tiny_config, jax.random.PRNGKey(0))
