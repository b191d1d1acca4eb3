"""Sharded photon runs and renders (``parallel.mesh``)."""
