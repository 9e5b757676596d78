import os

# The tests run on the CPU, with a virtual 8-device mesh for the sharding
# tests; the GPU path is proven by chip_smoke.py on the card.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

try:
    import jax

    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

import pytest  # noqa: E402

REF = "/root/reference/test"


def ref_fixture(name: str) -> str:
    path = os.path.join(REF, name)
    if not os.path.exists(path):
        pytest.skip(f"reference fixture {name} not available")
    return path
