"""Test configuration: run on a virtual 8-device CPU mesh with float64 enabled
so the dense oracles are exact.  The TPU bench path uses float32; tests here
exercise the same code on the CPU backend (SURVEY.md §7, reference test
strategy §4)."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# Modules dominated by interpret-mode Pallas runs or multi-process setups
# (the full suite is ~3 h on a 1-CPU box).  `-m "not slow"` is the fast
# core pass; CI/judge runs everything.
_SLOW_MODULES = {
    "test_sharding_paths",   # 20+ sharded-vs-single interpret-mode steps
    "test_multihost",        # 2 real jax.distributed processes
    "test_examples",         # steps all 18 reference example cases
}
# Individual interpret-mode integration tests that each take minutes.
_SLOW_PREFIXES = (
    "test_pallas_step_integration",
    "test_pallas_dsmag",
    "test_pallas_xop",
    "test_pallas_wm",
    "test_pallas_scalar",
    "test_pallas_impdiff",
    "test_pallas_xwalled",
    "test_pallas_xywalled",
    "test_pallas_plane_valued",
    "test_pallas_cn_fold",
    "test_pallas_fillps_fusion",
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: interpret-mode / multi-process tests (minutes "
        "each); deselect with -m 'not slow' for the fast core pass")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the cales_torch CUDA "
        "kernels); skips where torch.cuda.is_available() is False")


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SLOW_MODULES or item.name.startswith(_SLOW_PREFIXES):
            item.add_marker(pytest.mark.slow)
