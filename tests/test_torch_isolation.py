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
    assert int(res.stdout.strip()) >= 35       # every module was imported


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

    # the arithmetic kernels: elementwise, divide, the posit-out GEMM
    a = PositArray(torch.empty(4, 8, dtype=torch.int16, device="meta"), P16_2)
    for call in (lambda: ops.elementwise("add", a, a),
                 lambda: ops.elementwise("fma", a, a, a),
                 lambda: ops.divide(a, a, mode="pacogen"),
                 lambda: ops.gemm(a, w, out_posit=True)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert sum(ops.plain_counts().values()) == 0
    assert sum(ops.launch_counts().values()) == 0


def test_training_entry_points_raise_without_a_gpu():
    """The training path asks for the card by default: the trainer, the
    train step and the CLI without --device cpu raise with no GPU, and the
    flash prefill and its backward on a non-CPU tensor take the kernel
    path, which raises instead of running the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, global_batch_at
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.trainer import train_loop

    cfg = get_smoke("smollm-360m")
    data = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    for call in (lambda: train_loop(cfg, OptConfig(), data, 1,
                                    verbose=False),
                 lambda: make_train_step(cfg, OptConfig()),
                 lambda: global_batch_at(0, data),
                 lambda: launch_train.main(["--arch", "smollm-360m",
                                            "--smoke", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    ops.reset_counters()
    q = torch.empty(1, 3, 4, 8, device="meta")
    k = torch.empty(1, 1, 4, 8, device="meta")
    for call in (lambda: ops.flash_prefill(q, k, k, 4, 0, return_lse=True),
                 lambda: ops.flash_prefill_bwd(q, k, k, q, q[..., 0], q, 4,
                                               0, n_kv=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert sum(ops.plain_counts().values()) == 0
    assert sum(ops.launch_counts().values()) == 0
