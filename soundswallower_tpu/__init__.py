"""soundswallower_tpu: finite-state-grammar recognizer and forced
aligner with the capabilities of SoundSwallower, built from scratch on
JAX/XLA.

Public API mirrors the reference Python binding
(py/_soundswallower.pyx: Config, Decoder, FsgModel, Vad, Endpointer,
Alignment, AlignmentEntry; py/soundswallower/__init__.py helpers).
"""

from __future__ import annotations

import os

import jax

# XLA's Triton GEMM emitter aborts the process (an LLVM layout error,
# "Dimensions must match ... register, lane, warp") while compiling some
# batch shapes of the scorer's one-hot matmuls on Hopper; cuBLAS takes
# them instead.  XLA reads the flag when its backend starts, so this
# must precede the first use of a device.
_xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_gpu_enable_triton_gemm" not in _xla_flags:
    os.environ["XLA_FLAGS"] = (
        _xla_flags + " --xla_gpu_enable_triton_gemm=false").strip()

# The front end requires float64 (see fe/frontend.py); enable x64 globally
# before any tracing.  f32/int paths are unaffected (explicit dtypes).
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR
# itself; without it the cache sits at one fixed, git-ignored path in
# the checkout (the path is part of the cache key, so it must not move).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import collections  # noqa: E402

from .config import Config  # noqa: E402
from .logmath import LogMath  # noqa: E402

__version__ = "0.1.0"

Arg = collections.namedtuple("Arg", ["name", "default", "doc", "type", "required"])
Seg = collections.namedtuple("Seg", ["text", "start", "duration", "ascore", "lscore"])
Hyp = collections.namedtuple("Hyp", ["text", "score", "prob"])


def __getattr__(name):
    # Lazy imports keep `import soundswallower_tpu` light; the heavy
    # modules (jax tracing etc.) load on first use.
    if name == "Decoder":
        from .decoder import Decoder
        return Decoder
    if name == "FsgModel":
        from .fsg import FsgModel
        return FsgModel
    if name == "TpuAligner":
        from .aligner import TpuAligner
        return TpuAligner
    if name == "Vad":
        from .vad import Vad
        return Vad
    if name == "Endpointer":
        from .endpointer import Endpointer
        return Endpointer
    raise AttributeError(name)


__all__ = [
    "Arg",
    "Config",
    "Decoder",
    "Endpointer",
    "FsgModel",
    "Hyp",
    "LogMath",
    "Seg",
    "TpuAligner",
    "Vad",
    "get_audio_data",
    "get_model_path",
]


def get_audio_data(input_file: str):
    """Single-channel WAV or raw audio loader
    (py/soundswallower/__init__.py:43-64)."""
    import wave

    try:
        with wave.open(input_file) as wavfile:
            if wavfile.getnchannels() != 1:
                raise ValueError("Only supporting single-channel WAV")
            data = wavfile.readframes(wavfile.getnframes())
            return data, wavfile.getframerate()
    except wave.Error:
        with open(input_file, "rb") as rawfile:
            return rawfile.read(), None


def get_model_path(subpath: str | None = None) -> str:
    """Locate bundled/reference models (py/soundswallower/__init__.py:27).

    Checks $SOUNDSWALLOWER_MODEL_DIR, then a repo-local ``model/`` dir,
    then the mounted reference models.
    """
    for root in (
        os.environ.get("SOUNDSWALLOWER_MODEL_DIR"),
        os.path.join(os.path.dirname(__file__), "model"),
        "/root/reference/model",
    ):
        if root and os.path.isdir(root):
            return os.path.join(root, subpath) if subpath else root
    raise RuntimeError("No model directory found")
