"""Test harness config: the CPU platform with 8 virtual devices, which
the multi-device tests build their meshes on."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

from restir_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

assert jax.devices()[0].platform == "cpu", jax.devices()

# persistent compile cache: the suite's wall time is dominated by CPU XLA
# compiles
configure_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-frame statistical / golden tests (builder loop: "
        "run `pytest -m 'not slow'` for a quick pass; the full suite "
        "runs everything)",
    )
