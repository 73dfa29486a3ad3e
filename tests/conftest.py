"""Test harness config: the CPU with 8 virtual devices, unless told otherwise.

With ``JAX_PLATFORMS`` unset the suite runs on the CPU, where sharding tests
exercise real collectives on an 8-device virtual mesh (SURVEY.md §4) and the
Pallas kernel runs in interpret mode.  Tests marked ``gpu`` need a card:
they run under ``JAX_PLATFORMS=cuda`` (``python chip_smoke.py`` does this)
and skip, from a fixture, anywhere else.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

if not os.environ.get("JAX_PLATFORMS"):
    import jax

    jax.config.update("jax_platforms", "cpu")
