"""On-device data transforms."""
