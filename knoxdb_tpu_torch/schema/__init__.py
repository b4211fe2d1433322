"""Port of knoxdb_tpu.schema (see the package docstring)."""
