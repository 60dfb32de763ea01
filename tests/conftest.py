"""Test harness configuration.

Per SURVEY.md §4: tests run on the CPU backend with 8 virtual devices so
multi-card sharding paths are exercised without an accelerator. The env
vars must be set before the first `import jax` anywhere in the test
process. Tests that need the GPU carry the `gpu` marker and skip here
(the `gpu` fixture decides, at run time).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture()
def tmp_data_dir(tmp_path):
    return tmp_path


@pytest.fixture()
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run `python -m pytest -m gpu` on one")
    return jax.devices()
