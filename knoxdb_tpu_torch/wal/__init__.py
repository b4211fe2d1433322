"""Write-ahead log (the port of knoxdb_tpu/wal)."""

from .wal import Record, RecordType, RecoveryMode, Wal, WalError  # noqa: F401
