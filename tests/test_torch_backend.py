"""Backend selection of the PyTorch port, and the decode step's route to the
flash decode kernel on the "cuda" backend.

Selection only inspects the model and the device's type, so a
``torch.device("cuda")`` is enough here without a GPU."""

import pytest
import torch

from ganq_tpu_torch.core.backend import select_backend
from ganq_tpu_torch.models import synthetic
from ganq_tpu_torch.models import transformer as ttr
from ganq_tpu_torch.ops import qlinear as tql
from ganq_tpu_torch.ops.packing import pack_int_rows
from ganq_tpu_torch.serve import engine as teng
from test_torch_packing import torch_threads_per_worker  # noqa: F401

CPU, GPU = torch.device("cpu"), torch.device("cuda")


def _uniform_linear(bits=4, out_f=8, in_f=32):
    gen = torch.Generator().manual_seed(0)
    codes = torch.randint(0, 2**bits, (out_f, in_f), generator=gen,
                          dtype=torch.int32)
    return tql.QLinear("uniform", {
        "qweight": pack_int_rows(codes, bits),
        "scales": torch.full((out_f, 1), 0.01 * 16 / 2**bits)}, bits=bits,
        in_features=in_f)


def _lut_linear(bits):
    gen = torch.Generator().manual_seed(0)
    lut = torch.randn((8, 2**bits), generator=gen)
    idx = torch.randint(0, 2**bits, (8, 32), generator=gen)
    return tql.lut_linear(lut, idx, bits)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_cpu_takes_reference_and_card_takes_cuda(bits):
    model = torch.nn.ModuleList([_lut_linear(bits), tql.dense_linear(
        torch.ones(4, 4))])
    assert select_backend(model, CPU) == "reference"
    assert select_backend(model, GPU) == "cuda"
    # the plain path on the card only when asked for
    assert select_backend(model, GPU, "reference") == "reference"


@pytest.mark.parametrize("make,match", [
    (lambda: _lut_linear(1), "2, 3, 4 or 8 bits"),
])
def test_card_raises_for_a_linear_without_kernel(make, match):
    model = torch.nn.ModuleList([_lut_linear(4), make()])
    with pytest.raises(NotImplementedError, match=match):
        select_backend(model, GPU)
    assert select_backend(model, CPU) == "reference"


def _w8_linear():
    return tql.recode_w8(_lut_linear(4))


@pytest.mark.parametrize("linears,card", [
    ((lambda: _uniform_linear(4),), "cuda_a8"),
    ((lambda: _uniform_linear(8), _w8_linear), "cuda_a8"),
    ((_w8_linear,), "cuda_a8"),
    ((lambda: _uniform_linear(2),), "cuda"),
    ((lambda: _uniform_linear(3), lambda: _uniform_linear(4)), "cuda"),
    ((lambda: _lut_linear(4), lambda: _uniform_linear(4)), "cuda"),
    ((lambda: _lut_linear(3), _w8_linear), "cuda"),
])
def test_card_selects_cuda_a8_before_cuda(linears, card):
    """The auto order on a card is "cuda_a8" (every quantized linear w8 or
    uniform at 4 or 8 bits, as the JAX package's pallas_a8) and then
    "cuda"; the CPU takes the reference backend."""
    model = torch.nn.ModuleList([make() for make in linears]
                                + [tql.dense_linear(torch.ones(4, 4))])
    assert select_backend(model, GPU) == card
    assert select_backend(model, GPU, "cuda") == "cuda"
    assert select_backend(model, CPU) == "reference"
    if card == "cuda":
        with pytest.raises(NotImplementedError, match="cuda_a8"):
            select_backend(model, GPU, "cuda_a8")


@pytest.mark.parametrize("backend", ["cuda", "cuda_a8"])
def test_cuda_backends_route_each_kind_to_its_kernel(monkeypatch, backend):
    """apply() sends uniform linears to kernel 5 ("cuda") or 6 ("cuda_a8")
    and w8 linears to kernel 7 or 8 (whose wrappers take their plain
    versions for these CPU tensors), below 1024 token rows."""
    from ganq_tpu_torch.ops import uniform_matmul as um
    from ganq_tpu_torch.ops import w8_matmul as w8m

    seen = []
    for mod, name in ((um, "uniform_matmul"), (um, "uniform_a8_matmul"),
                      (w8m, "w8_matmul"), (w8m, "w8a8_matmul")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, f=fn, n=name:
                            seen.append(n) or f(*a))
    x = torch.randn((3, 32), generator=torch.Generator().manual_seed(4))
    for lin in (_uniform_linear(4), _w8_linear()):
        ref = tql.apply(lin, x, "reference")
        got = tql.apply(lin, x, backend)
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, rtol=0.05,
                                   atol=0.05 * float(ref.abs().max()))
    a8 = backend == "cuda_a8"
    assert seen == (["uniform_a8_matmul", "w8a8_matmul"] if a8
                    else ["uniform_matmul", "w8_matmul"])


def test_bad_requests_raise():
    model = torch.nn.ModuleList([_lut_linear(4)])
    with pytest.raises(ValueError, match="requires a CUDA device"):
        select_backend(model, CPU, "cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        select_backend(model, CPU, "pallas")


@pytest.mark.parametrize("batch,heads,kv_heads", [(1, 2, 1), (65, 2, 2),
                                                  (3, 4, 1)])
def test_cuda_decode_step_always_takes_flash_decode(monkeypatch, batch, heads,
                                                    kv_heads):
    """Every layer of a "cuda" decode step calls flash decode, whatever the
    batch (65 is past the JAX gate's 64) or the head width (12 is no multiple
    of 8: the kernel's wrapper, not the caller, decides to launch or raise)."""
    cfg = synthetic.llama_config(hidden=12 * heads, inter=32, layers=2,
                                 heads=heads, kv_heads=kv_heads, vocab=64)
    model = synthetic.make_model(cfg, kind="lut", seed=0, device="cpu")
    calls = []
    flash = ttr.flash_decode_attention

    def spy(q, k_cache, v_cache, pos, scale):
        calls.append(tuple(q.shape))
        return flash(q, k_cache, v_cache, pos, scale)

    monkeypatch.setattr(ttr, "flash_decode_attention", spy)
    ids = torch.randint(0, 64, (batch, 5), generator=torch.Generator()
                        .manual_seed(1))
    with torch.inference_mode():
        cache = teng.init_cache(cfg, batch, 16, "cpu")
        tok = teng.prefill(cfg, model, cache, ids, "cuda").argmax(-1)
        assert calls == []                       # prefill: plain attention
        pos = torch.tensor(5, dtype=torch.int32)
        teng.decode_step(cfg, model, cache, tok, pos, "cuda")
        assert calls == [(batch, heads, 12)] * cfg.num_hidden_layers
        teng.decode_step(cfg, model, cache, tok, pos + 1, "reference")
    assert len(calls) == cfg.num_hidden_layers   # reference: plain attention


def test_cuda_decode_step_takes_one_token():
    cfg = synthetic.llama_config(hidden=32, inter=32, layers=1, heads=2,
                                 kv_heads=1, vocab=64)
    model = synthetic.make_model(cfg, kind="lut", seed=0, device="cpu")
    cache = teng.init_cache(cfg, 1, 16, "cpu")
    x = torch.zeros((1, 2, 32), dtype=torch.bfloat16)
    rope = ttr.rope_tables(cfg, torch.arange(2)[None])
    with pytest.raises(ValueError, match="one token"):
        ttr.layer_forward(cfg, model.layers[0], x, None, rope, cache=cache[0],
                          cache_pos=torch.tensor(3), backend="cuda")


def test_load_takes_a_backend(tmp_path):
    """``GanqModel.load(..., backend=...)`` passes the choice through
    ``select_backend``: the plain path when asked for, and a refusal for the
    kernels on a device that has none."""
    from ganq_tpu_torch import GanqModel, QuantizeConfig
    from ganq_tpu_torch.formats.checkpoint import save_quantized
    from ganq_tpu_torch.models import hf_import

    cfg = synthetic.llama_config(hidden=32, inter=32, layers=1, heads=2,
                                 kv_heads=1, vocab=64)
    save_quantized(str(tmp_path), hf_import.config_to_hf(cfg),
                   QuantizeConfig(bits=4, quant_method="ganq"),
                   synthetic.make_model(cfg, kind="lut", seed=0, device="cpu"))
    g = GanqModel.load(str(tmp_path), device="cpu", backend="reference")
    assert g.backend == "reference"
    assert g.generate([[1, 2, 3]], max_new_tokens=2, max_seq=8).shape == (1, 2)
    with pytest.raises(ValueError, match="requires a CUDA device"):
        GanqModel.load(str(tmp_path), device="cpu", backend="cuda")


def test_forward_passes_the_backend_to_the_lm_head(monkeypatch):
    """``forward`` hands its backend to ``unembed``: a quantized untied
    lm_head on the "cuda" backend reaches the LUT kernel's wrapper (which
    takes its plain version for these CPU tensors), not the plain path."""
    from ganq_tpu_torch.ops import lut_matmul as lm
    from ganq_tpu_torch.ops import qlinear

    cfg = synthetic.llama_config(hidden=32, inter=32, layers=1, heads=2,
                                 kv_heads=1, vocab=64)
    model = synthetic.make_model(cfg, kind="lut", seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    idx = torch.randint(0, 16, (64, 32), generator=gen)
    model.lm_head = qlinear.lut_linear(torch.randn((64, 16), generator=gen),
                                       idx, 4)
    seen = []
    plain = lm.lut_matmul_reference

    def spy(x, lut, packed, bits):
        seen.append(lut.shape[0])
        return plain(x, lut, packed, bits)

    monkeypatch.setattr(lm, "lut_matmul_reference", spy)
    ids = torch.tensor([[1, 2, 3]])
    with torch.inference_mode():
        ref = ttr.forward(cfg, model, ids, "reference")
        assert seen == []
        got = ttr.forward(cfg, model, ids, "cuda")
    assert seen[-1] == cfg.vocab_size          # the lm_head went through it
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_cuda_a8_decode_step_takes_flash_decode(monkeypatch):
    """A "cuda_a8" decode step runs flash decode in every layer, as the JAX
    package's pallas_a8 does, and a quantized lm_head keeps full-precision
    activations: it goes to kernel 5, the layers' linears to kernel 6."""
    from ganq_tpu_torch.ops import uniform_matmul as um

    cfg = synthetic.llama_config(hidden=512, inter=512, layers=2, heads=4,
                                 kv_heads=1, vocab=64)   # widths the gate admits
    model = synthetic.make_model(cfg, kind="uniform", bits=8, seed=0,
                                 device="cpu")
    model.lm_head = _uniform_linear(8, out_f=64, in_f=512)
    assert select_backend(model, GPU) == "cuda_a8"
    calls, rows = [], []
    flash = ttr.flash_decode_attention
    monkeypatch.setattr(ttr, "flash_decode_attention",
                        lambda *a: calls.append(1) or flash(*a))
    for name in ("uniform_matmul", "uniform_a8_matmul"):
        fn = getattr(um, name)
        monkeypatch.setattr(um, name, lambda x, qw, *a, f=fn, n=name:
                            rows.append((n, qw.shape[0])) or f(x, qw, *a))
    with torch.inference_mode():
        cache = teng.init_cache(cfg, 2, 16, "cpu")
        ids = torch.randint(0, 64, (2, 4), generator=torch.Generator()
                            .manual_seed(1))
        tok = teng.prefill(cfg, model, cache, ids, "reference").argmax(-1)
        rows.clear()
        teng.decode_step(cfg, model, cache, tok, torch.tensor(4), "cuda_a8")
    assert len(calls) == cfg.num_hidden_layers
    assert rows[-1] == ("uniform_matmul", 64)               # the lm_head
    assert {n for n, _ in rows[:-1]} == {"uniform_a8_matmul"}
