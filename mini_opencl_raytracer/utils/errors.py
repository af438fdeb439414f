"""Typed device-error layer: decode runtime/compiler failures into
actionable exceptions.

The reference wraps every OpenCL status in a ``CLException`` carrying a
74-entry error-name table (``GetClErrorString``, CLutils.h:29-105) and
surfaces it as a message box (CLEngineBase.cpp:181-185). The JAX/XLA
analog: runtime errors arrive as ``XlaRuntimeError``/``JaxRuntimeError``
with long vendor messages — this module classifies the common classes a
renderer hits (device OOM, missing accelerator, sharding mismatches)
into typed exceptions with the framework-level remedy attached.
"""

from __future__ import annotations

from typing import Callable, TypeVar

T = TypeVar("T")


class RaytracerError(RuntimeError):
    """Base class for decoded device-layer failures."""


class DeviceOutOfMemoryError(RaytracerError):
    """Device memory exhausted. Remedies: lower width/height or spp, keep
    ``remat=True``, or shard pixels over more GPUs
    (parallel/shard.render_sample_dp)."""


class NoAcceleratorError(RaytracerError):
    """No usable accelerator backend. Remedies: set JAX_PLATFORMS=cpu
    for CPU execution (tests do), or install JAX's CUDA plugin and check
    that the NVIDIA driver sees the GPU (nvidia-smi)."""


class ShardingError(RaytracerError):
    """Mesh/sharding mismatch (e.g. pixel count not divisible by the dp
    axis). Remedies: pick width*height divisible by the mesh axis sizes
    or adjust MeshConfig."""


_CLASSIFIERS = (
    (("RESOURCE_EXHAUSTED", "Allocation (size=", "would exceed memory",
      "Out of memory", "out of memory", "CUDA_ERROR_OUT_OF_MEMORY"),
     DeviceOutOfMemoryError),
    (("Backend '", "Unable to initialize backend", "No visible device",
      "no supported devices", "CUDA_ERROR_NO_DEVICE",
      "no CUDA-capable device"), NoAcceleratorError),
    (("not divisible", "sharding", "NamedSharding mismatch"),
     ShardingError),
)


def _is_runtime_exc(exc: BaseException) -> bool:
    """Only classify exception types the JAX/XLA runtime actually
    raises (XlaRuntimeError/JaxRuntimeError subclass RuntimeError;
    sharding/backend misuse arrives as ValueError/RuntimeError) — an
    arbitrary application error whose *message* happens to mention
    'sharding' must not be rewrapped and truncated."""
    return isinstance(exc, (RuntimeError, ValueError, OSError))


def decode_error(exc: BaseException) -> RaytracerError | None:
    """Map a raw runtime exception to a typed RaytracerError (or None if
    unrecognized). The original exception should be chained by the
    caller (``raise decoded from exc``)."""
    if isinstance(exc, RaytracerError) or not _is_runtime_exc(exc):
        return None
    msg = str(exc)
    for needles, cls in _CLASSIFIERS:
        if any(n in msg for n in needles):
            summary = msg.strip().splitlines()[0][:300]
            return cls(f"{cls.__doc__.splitlines()[0]} [{summary}]")
    return None


def run_decoded(fn: Callable[[], T]) -> T:
    """Run ``fn``, re-raising recognized device failures as typed
    exceptions (the CLI's equivalent of the reference's CLException ->
    MessageBox path, with the original error chained)."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - deliberate broad decode
        decoded = decode_error(exc)
        if decoded is not None:
            raise decoded from exc
        raise
