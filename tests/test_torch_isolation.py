"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points never fall back to the CPU on their own."""

import os
import subprocess
import sys

import pytest
import torch

import ganq_tpu_torch
from ganq_tpu_torch import GanqModel
from ganq_tpu_torch.formats import checkpoint
from ganq_tpu_torch.models import hf_import, synthetic
from ganq_tpu_torch.serve.engine import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ganq_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ganq_tpu_torch.__path__,
                                                "ganq_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "ganq_tpu"
             or k.startswith("ganq_tpu."))
import numpy as np
from ganq_tpu_torch.ops import kmeans_exact
kmeans_exact.kmeans_rows_exact(np.arange(12.0).reshape(2, 6), np.ones(6), 2)
maps = open("/proc/self/maps").read()
if "libkmeans1d-" not in maps or "ganq_tpu/native" in maps:
    bad.append("kmeans library")
print(len(names), bad)
sys.exit(1 if bad or len(names) < 33 else 0)
"""


def test_no_jax_and_no_jax_package_in_a_fresh_process():
    """Every module of the port imports without JAX or ganq_tpu, and the
    exact k-means runs on the port's own build of its own source (never the
    JAX package's native library)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("[]")


def test_sources_do_not_name_the_jax_package():
    root = os.path.dirname(ganq_tpu_torch.__file__)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert "import jax" not in text and "from jax" not in text, f
                assert "from ganq_tpu." not in text, f
                assert "import ganq_tpu." not in text, f
                assert "ganq_tpu/native" not in text, f


def test_entry_points_do_not_silently_run_on_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GanqModel.load(str(tmp_path))
    cfg = synthetic.llama_config(hidden=32, inter=64, layers=1, heads=2,
                                 kv_heads=1, vocab=64)
    hf_cfg = hf_import.config_to_hf(cfg)
    for entry in (lambda: synthetic.make_model(cfg, kind="lut", seed=0),
                  lambda: synthetic.make_model(cfg, kind="dense"),
                  lambda: checkpoint.load_quantized(str(tmp_path)),
                  lambda: hf_import.params_from_dir(str(tmp_path)),
                  lambda: hf_import.params_from_state_dict({}, hf_cfg),
                  lambda: hf_import.params_from_numpy(hf_cfg, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    model = synthetic.make_model(cfg, kind="lut", seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, model)
    # an explicit CPU request runs
    out = Engine(cfg, model, device="cpu", max_seq=16).generate(
        [[1, 2, 3]], max_new_tokens=2)
    assert out.shape == (1, 2)


def test_kernel_wrappers_never_fall_back_for_cuda_tensors():
    """On a CUDA tensor the wrappers launch or raise: their only branch to
    the plain version tests for a CPU tensor. The a8 wrappers' other branch
    is the JAX package's full-precision route for the shapes its gate
    refuses, and it calls the kernel 5 / kernel 7 wrapper, never a plain
    version."""
    import inspect

    from ganq_tpu_torch.ops import (fused_attention, ganq_solver, lut_matmul,
                                    uniform_matmul, w8_matmul)

    for fn, plain, route in (
            (lut_matmul.lut_matmul, "lut_matmul_reference", None),
            (fused_attention.flash_decode_attention, "flash_decode_reference",
             None),
            (ganq_solver.s_step_blocked_kernel, "s_step_blocked", None),
            (ganq_solver.s_step_kernel, "s_step", None),
            (uniform_matmul.uniform_matmul, "uniform_matmul_reference", None),
            (uniform_matmul.uniform_a8_matmul, "uniform_a8_reference",
             "return uniform_matmul(x, qweight, scales, zeros, g_idx, bits)"),
            (w8_matmul.w8_matmul, "w8_matmul_reference", None),
            (w8_matmul.w8a8_matmul, "w8a8_reference",
             "return w8_matmul(x, w8, scale)")):
        src = inspect.getsource(fn)
        assert src.count(plain + "(") == 1
        assert 'device.type == "cpu":\n        return ' + plain + "(" in src
        assert "except" not in src
        assert "_reference(" not in src.replace(plain + "(", "")
        assert src.count("return ") == (3 if route else 2)
        if route:
            assert route in src


def test_fused_kernel_wrappers_never_fall_back_for_cuda_tensors():
    """Kernels 9-12 likewise: the one branch to the plain version tests for
    a CPU tensor; kernel 9's other branch is the JAX package's
    full-precision route for the shapes its ``ok`` test refuses (computed
    outside any kernel there, and here)."""
    import inspect

    from ganq_tpu_torch.ops import (fused_attention, fused_layer, fused_mlp,
                                    megastep)

    for fn, plain, route in (
            (fused_mlp.fused_mlp_w8a8, "fused_mlp_plain",
             "return fused_mlp_fallback("),
            (fused_attention.fused_qkv_rope_w8a8, "fused_qkv_rope_plain", None),
            (fused_layer.attn_half_decode_w8a8, "attn_half_plain", None),
            (megastep.megastep_decode_w8a8, "megastep_plain", None)):
        src = inspect.getsource(fn)
        assert src.count(plain + "(") == 1
        assert 'device.type == "cpu":\n        return ' + plain + "(" in src
        assert "except" not in src
        assert src.count("return ") == (3 if route else 2)
        if route:
            assert route in src
        assert ".launches += 1" in src


def test_whole_step_wrappers_never_fall_back_for_cuda_tensors():
    """Kernels 13 and 14 likewise: the one branch to the plain version
    tests for a CPU tensor, and every other path launches the kernel (the
    features of later sub-slices raise before either)."""
    import inspect

    from ganq_tpu_torch.ops import megastep4, megastep_lowbit

    for fn, plain in ((megastep4.megastep4_decode, "megastep4_plain"),
                      (megastep_lowbit.megastep_lowbit_decode,
                       "megastep_lowbit_plain")):
        src = inspect.getsource(fn)
        assert src.count(plain + "(") == 1
        assert 'device.type == "cpu":\n        return ' + plain + "(" in src
        assert "except" not in src
        assert src.count("return ") == 2
        assert "launch_grouped(" in src and ".launches += 1" in src


def test_moe_expert_wrapper_never_falls_back_for_cuda_tensors():
    """Kernel 15 likewise: its one branch to the plain version tests for a
    CPU tensor; every other path launches the kernel or raises, and the
    MoE combine reaches it only on "cuda_a8" (or, on the CPU, with
    ``GANQ_MOE_MEGA=1``)."""
    import inspect

    from ganq_tpu_torch.models import transformer
    from ganq_tpu_torch.ops import moe_expert

    src = inspect.getsource(moe_expert.moe_expert_decode)
    assert src.count("moe_expert_plain(") == 1
    assert 'device.type == "cpu":\n        return moe_expert_plain(' in src
    assert "except" not in src
    assert src.count("return ") == 2
    assert "cuda_lib.check(" in src and ".launches += 1" in src
    combine = inspect.getsource(transformer._moe_combine)
    assert 'backend == "cuda_a8"' in combine
    assert 'h.device.type != "cpu" or env == "1"' in combine
