"""Test configuration: run all tests on a virtual 8-device CPU mesh.

Mirrors the reference's property that the whole suite runs without special
hardware (its MPI layer compiles to single-task no-ops — SURVEY.md section 4):
distributed logic here is exercised on `--xla_force_host_platform_device_count=8`
CPU devices, and the Pallas kernels run in interpret mode
(lucille_tpu/base/backend.py).  GPU checks live in chip_smoke.py.

Must set env vars BEFORE jax initializes a backend, hence module scope.
"""

import os

# Force, don't setdefault: unit tests run on the virtual CPU mesh even
# on a machine with a GPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

# If jax was imported before this file (a plugin), its config has already
# read JAX_PLATFORMS; re-point it.  Backends initialize lazily, so this
# wins as long as no array has been created yet.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", (
    "tests must run on the virtual CPU mesh, got " + jax.devices()[0].platform
)
