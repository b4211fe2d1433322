"""Test helpers of the port: random kernel operands (kernel_cases),
executable assertions (assert_) and the seeded scenario runner with a
model oracle (scenario), the last two carried over from
knoxdb_tpu/testing/."""

from . import assert_, scenario  # noqa: F401
from .kernel_cases import (misaligned_copy, random_tree_case,  # noqa: F401
                           split_layouts, split_masks)
