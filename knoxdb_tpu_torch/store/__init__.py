"""KV storage backends + segment serialization (the port of
knoxdb_tpu/store)."""

from . import kv, segio  # noqa: F401
