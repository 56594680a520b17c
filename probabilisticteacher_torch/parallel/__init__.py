"""Host-to-device input pipelining and data parallel over ranks."""

from .prefetch import DevicePrefetcher, host_to_device  # noqa: F401
