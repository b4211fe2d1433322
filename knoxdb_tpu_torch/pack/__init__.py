"""Port of knoxdb_tpu.pack (see the package docstring)."""
