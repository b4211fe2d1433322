"""Port of knoxdb_tpu.utils (see the package docstring)."""
