"""GPU-mirrored storage engine (``cuda``): host-authoritative store plus a
sorted block mirror on the device whose scans run as CUDA kernels."""

from . import engine  # noqa: F401  (registers the engine)
