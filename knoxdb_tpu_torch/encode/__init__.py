"""Port of knoxdb_tpu.encode (see the package docstring)."""
