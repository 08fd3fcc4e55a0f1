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


def test_moe_entry_points_raise_without_a_gpu():
    """The MoE path asks for the card by default and its modules stand
    alone: models/moe.py and kernels/grouped_gemm.py import no JAX and no
    repro, the olmoe config's init raises on "cuda" with no GPU, and the
    grouped GEMM, its dW and the MoE block on a non-CPU tensor take the
    kernel path, which raises instead of running the plain versions."""
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro(\.|\s|$)"
                     r"|from\s+repro(\.|\s))", re.M)
    for rel in ("models/moe.py", "kernels/grouped_gemm.py",
                "configs/olmoe_1b_7b.py"):
        src = open(os.path.join(SRC, "repro_torch", rel)).read()
        assert not pat.search(src), rel
    code = ("import sys\n"
            "import repro_torch.models.moe, repro_torch.kernels.grouped_gemm\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or "
            "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_params
    from repro_torch.quant.policy import PositPolicy

    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(get_smoke("olmoe-1b-7b"), device="cuda")
    ops.reset_counters()
    x = torch.empty(6, 8, device="meta")
    w = torch.empty(2, 8, 4, device="meta")
    off = torch.zeros(3, dtype=torch.int32, device="meta")
    p = {"router": torch.empty(8, 2, device="meta"), "w_up": w,
         "w_gate": w, "w_down": torch.empty(2, 4, 8, device="meta")}
    for call in (lambda: ops.grouped_matmul(x, w, off),
                 lambda: GG.posit_grouped_gemm_dw(x, x, off),
                 lambda: moe.moe_block(x.reshape(1, 6, 8), p, n_experts=2,
                                       top_k=1, act="swiglu",
                                       policy=PositPolicy())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert sum(ops.plain_counts().values()) == 0
    assert sum(ops.launch_counts().values()) == 0


def test_recurrent_entry_points_raise_without_a_gpu():
    """The recurrent serving path stands alone and asks for the card: its
    modules import no JAX and no repro, the two configs' init raises on
    "cuda" with no GPU, and the WKV scan (K12), the RG-LRU scan (K13) and
    the [BH, Sq, D] attention (K14) on a non-CPU tensor take the kernel
    path, which raises instead of running the plain versions."""
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro(\.|\s|$)"
                     r"|from\s+repro(\.|\s))", re.M)
    mods = ("models/rwkv6.py", "models/griffin.py",
            "kernels/recurrent_scan.py", "serving/backends.py",
            "configs/rwkv6_3b.py", "configs/recurrentgemma_9b.py")
    for rel in mods:
        src = open(os.path.join(SRC, "repro_torch", rel)).read()
        assert not pat.search(src), rel
    code = ("import sys\n"
            "import repro_torch.models.rwkv6, repro_torch.models.griffin\n"
            "import repro_torch.kernels.recurrent_scan\n"
            "import repro_torch.serving.backends\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or "
            "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_smoke
    from repro_torch.core.array import PositArray
    from repro_torch.core.types import P16_2
    from repro_torch.kernels import ops
    from repro_torch.kernels import recurrent_scan as RS
    from repro_torch.models.transformer import init_params

    for arch in ("rwkv6-3b", "recurrentgemma-9b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(get_smoke(arch), device="cuda")
    ops.reset_counters()
    r = torch.empty(2, 3, 4, 8, device="meta")
    u = torch.empty(3, 8, device="meta")
    s0 = PositArray(torch.empty(2, 3, 8, 8, dtype=torch.int16,
                                device="meta"), P16_2)
    a = torch.empty(2, 4, 16, device="meta")
    h0 = torch.empty(2, 16, device="meta")
    nn = torch.ones(2, dtype=torch.int32, device="meta")
    q = torch.empty(6, 4, 8, device="meta")
    for call in (lambda: ops.wkv_scan(r, r, r, r, u, s0),
                 lambda: RS.wkv_scan(r, r, r, r, u, s0.bits, nn,
                                     cfg_state=P16_2, posit_state=True),
                 lambda: ops.rglru_scan(a, a, h0, cfg_state=P16_2),
                 lambda: RS.rglru_scan(a, a, h0, nn, cfg_state=None,
                                       posit_state=False),
                 lambda: ops.attention(q, q, q)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert sum(ops.plain_counts().values()) == 0
    assert sum(ops.launch_counts().values()) == 0
