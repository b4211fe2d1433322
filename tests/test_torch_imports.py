"""knoxdb_tpu_torch imports torch and never jax, in any module."""

import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import knoxdb_tpu_torch as K\n"
        "mods = [m.name for m in pkgutil.walk_packages(K.__path__, "
        "'knoxdb_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "for m in ('exec.scan', 'exec.groupby', 'exec.device', 'exec.join',\n"
        "          'ops.group_kernels', 'ops.cuda_build', 'ops.compact',\n"
        "          'ops.sort_kernels', 'ops.group_chunk_kernels',\n"
        "          'encode.schemes', 'encode.alp', 'exec.rewrite'):\n"
        "    assert 'knoxdb_tpu_torch.' + m in mods, mods\n"
        "assert 'jax' not in sys.modules and 'knoxdb_tpu' not in sys.modules\n"
        "assert 'torch' in sys.modules\n"
        "print(len(mods))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20
