"""Host-to-device input pipelining (one process, one card)."""

from .prefetch import DevicePrefetcher, host_to_device  # noqa: F401
