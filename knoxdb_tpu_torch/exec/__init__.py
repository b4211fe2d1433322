"""Port of knoxdb_tpu.exec (see the package docstring)."""
