"""Engine runtime core: catalog, MVCC transactions, tables, tasks (the
port of knoxdb_tpu/engine)."""

from .engine import Engine, Options, Tx  # noqa: F401
from .table import Table, TableMetrics, TableState  # noqa: F401
