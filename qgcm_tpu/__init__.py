"""qgcm_tpu: a quasi-geostrophic coupled ocean-atmosphere model in JAX.

A brand-new JAX/XLA implementation with the capabilities of Q-GCM v1.5.0
(k247 fork). This is NOT a port: the numerics are re-derived for an
accelerator -- batched 2-D spectral elliptic solves instead of
sequential tridiagonal sweeps, fused stencil updates under jit,
`lax.scan` time loops, and `shard_map` domain decomposition over a
device mesh. It runs on an NVIDIA GPU (production) and on the CPU
(tests); qgcm_tpu/backend.py decides what differs between them.

Precision policy: model *initialisation* (eigenmodes, radiation balance,
homogeneous solutions, constraint matrices) always runs in float64 on the
host (NumPy). The *stepped fields* run in a configurable dtype:
float64 by default on the CPU (parity with the double-precision
reference), float32 by default on the GPU for throughput (float64 on
request).
"""

import jax

# The reference model (Q-GCM) is a double-precision Fortran code; the
# delicate constraint algebra and parity tests need f64 available.
# Field dtype remains configurable per-run (see ModelConfig.dtype).
jax.config.update("jax_enable_x64", True)

from .config import (ModelConfig, OceanConfig, AtmosConfig,  # noqa: E402,F401
                     MixedLayerConfig, RadiationConfig, SpongeConfig,
                     PRESETS)
from .model import build_model, Model  # noqa: E402,F401
from .params import RunParams, parse_input_params  # noqa: E402,F401
from .run import run_case, Driver  # noqa: E402,F401

__version__ = "0.1.0"
