"""Host-side utilities: ``interop`` (carrying tables and state across from
the JAX package as numpy arrays) and ``checkpoint`` (snapshots and resume
of long photon runs)."""
