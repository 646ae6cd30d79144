"""Experimental APIs (reference: python/ray/experimental/): channels and
device objects."""
