"""restir_tpu — a real-time ReSTIR DI/GI renderer in JAX.

A ground-up JAX/XLA re-design of the capabilities of the CUDA
reference (HummaWhite/ReSTIR): scene loading, SAH/MTBVH acceleration,
physically-based BSDFs, NEE with alias-table light sampling, ReSTIR
direct/indirect illumination with temporal+spatial reservoir reuse,
EAW / SVGF denoisers, and a headless rendering runtime.

Design: every render pass is a pure function `(state, scene, camera,
seed) -> state'` over SoA ``[H, W]`` pixel buffers, jit-compiled into a
single frame step. Thread-divergent CUDA control flow becomes masked
vector ops; `__syncthreads` hacks become pass boundaries; global mutable
settings become a frozen static config.
"""

__version__ = "0.1.0"

from .config import (  # noqa: E402,F401
    DenoiserType,
    RenderConfig,
    ReuseMode,
    ToneMapping,
    TracerType,
)
