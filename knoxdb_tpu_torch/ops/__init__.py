"""Port of knoxdb_tpu.ops (see the package docstring)."""
