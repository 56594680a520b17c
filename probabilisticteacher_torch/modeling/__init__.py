"""Backbone, heads and the detector."""
