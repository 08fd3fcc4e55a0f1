"""repro_torch stands alone: it imports neither JAX nor the JAX package,
and a kernel request off the CPU never computes on the CPU."""
from __future__ import annotations

import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "'jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'))))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20       # every module was imported


def test_sources_name_no_jax_and_no_repro():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro(\.|\s|$)"
                     r"|from\s+repro(\.|\s))", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    offenders = [f for f in files if pat.search(open(f).read())]
    assert not offenders, offenders


def test_cuda_requests_raise_without_a_gpu():
    """With no CUDA device, asking for one raises; a tensor that is not on
    the CPU (a meta tensor here) goes to the kernel path, which raises
    instead of computing the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core.array import PositArray
    from repro_torch.core.types import P16_2
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.configs import get_smoke

    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(get_smoke("smollm-360m"), device="cuda")
    ops.reset_counters()
    x = torch.empty(2, 8, device="meta")
    w = PositArray(torch.empty(8, 4, dtype=torch.int16, device="meta"), P16_2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.pw_matmul(x, w)
    assert ops.plain_counts()["pw_gemm"] == 0
    assert ops.launch_counts()["pw_gemm"] == 0
