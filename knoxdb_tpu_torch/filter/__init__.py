"""Port of knoxdb_tpu.filter (see the package docstring)."""
