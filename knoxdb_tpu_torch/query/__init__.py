"""Port of knoxdb_tpu.query (see the package docstring)."""
