"""CLI tools: kx (admin), packview (storage layout), walview (WAL dump),
carried over from knoxdb_tpu/tools/ (upstream cmd/kx, cmd/packview,
cmd/walview)."""
