"""Test configuration: CPU backend with a virtual 8-device mesh and x64.

Mirrors the project test strategy (SURVEY.md section 4): numerics are
validated on CPU in float64; multi-device sharding is validated on a
virtual 8-device CPU mesh via --xla_force_host_platform_device_count.
Kernels run in the Pallas interpreter (``interpret=True``). Run with
``JAX_PLATFORMS=cpu python -m pytest tests/ -m 'not slow'``; tests marked
``gpu`` need the card and skip here (``chip_smoke.py`` runs what they
cover on the GPU).
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
try:
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
except RuntimeError:
    pass  # no cpu backend (unexpected); run wherever the default is
# Persistent compilation cache: the GI while-loop body is a large XLA
# computation; caching makes test reruns fast.
from jrlqp_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
