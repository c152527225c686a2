import os

# Tests run on the CPU backend with 8 virtual devices, so the
# multi-device sharding paths are exercised without a multi-GPU host.
# Tests that need a real GPU carry the ``gpu`` marker and use the
# ``gpu_device`` fixture, which decides at run time (never at import or
# collection) whether a card is present.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    return gpus[0]
