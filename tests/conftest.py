"""Test configuration.

- Runs JAX on the CPU with 8 virtual devices so multi-device sharding
  semantics are testable without a multi-GPU host (SURVEY.md §4:
  mocked-mesh distributed tests). ``JAX_PLATFORMS`` is honoured when set,
  so ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` runs the
  ``gpu``-marked tests on a card.
- Enables x64: the reference stack (GPflow 1.x) is float64 end-to-end, and
  the oracle tests check parity at float64.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: $JAX_COMPILATION_CACHE_DIR when set, else a
# fixed directory in the checkout (gitignored).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(_root, ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none. Decided
    per test (never at import), so every worker collects the same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda,cpu on a card")
    return devices[0]
