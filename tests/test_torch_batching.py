"""The port's continuous batching against ganq_tpu's, on the same weights.

The model is ``tests/test_batching.py``'s 2-layer llama (hidden 64, vocab
128, ganq_tpu's synthetic dense weights from seed 3), cast to float32 in
both packages so that their logits are of one type; the port gets its
weights through ``models/hf_import.params_from_numpy``. Greedy and sampled
tokens must equal ganq_tpu's ``BatchingEngine`` request for request: the
port draws from the same ``PRNGKey(0)`` chain (``core/prng``), whose
uniforms are JAX's bit for bit.
"""

import os
import threading

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")

import jax
import jax.numpy as jnp

from ganq_tpu.models import synthetic as jsyn
from ganq_tpu.serve.batching import BatchingEngine as JBatching
from ganq_tpu.serve.engine import Engine as JEngine
from ganq_tpu_torch.models import hf_import as thf
from ganq_tpu_torch.models import synthetic as tsyn
from ganq_tpu_torch.serve.batching import BatchingEngine, ThreadedBatcher
from ganq_tpu_torch.serve.engine import Engine

from test_torch_serve import _flatten_jax
from test_torch_stacked import np_llama
from test_torch_packing import torch_threads_per_worker  # noqa: F401

VOCAB = 128


def _f32(params):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if getattr(a, "dtype", None) == jnp.bfloat16 else a, params)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port model): the same float32
    weights in both packages."""
    jcfg = jsyn.llama_config(hidden=64, inter=128, layers=2, heads=4,
                             kv_heads=2, vocab=VOCAB, max_pos=128)
    params = _f32(np_llama(jcfg, ("dense", "dense"), seed=3))
    tcfg = tsyn.llama_config(hidden=64, inter=128, layers=2, heads=4,
                             kv_heads=2, vocab=VOCAB, max_pos=128)
    _, model = thf.params_from_numpy(thf.config_to_hf(tcfg),
                                     _flatten_jax(params), device="cpu")
    return jcfg, params, tcfg, model


def _drive(eng, requests, late=()):
    """Submit ``requests`` (prompt, max_new, temperature), step until all
    drain, submitting ``late`` ones after the second step; {index:
    tokens} and the per-step emissions."""
    rid = {}
    for i, (p, n, t) in enumerate(requests):
        rid[eng.submit(p, max_new_tokens=n, temperature=t)] = i
    got = {i: [] for i in range(len(requests) + len(late))}
    steps = []
    for k in range(1000):
        if k == 2:
            for j, (p, n, t) in enumerate(late):
                rid[eng.submit(p, max_new_tokens=n, temperature=t)] = \
                    len(requests) + j
        out = eng.step()
        steps.append({rid[r]: v for r, v in out.items()})
        for r, toks in out.items():
            got[rid[r]].extend(toks)
        if k >= 2 and not eng.queue and all(s is None for s in eng.slot_req):
            break
    return got, steps


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=(n,)).astype(np.int32) for n in lens]


# (lens, max_new, temperatures, slots, buckets, late arrivals)
_CASES = {
    "mixed_buckets": ((5, 12, 26, 8), (4, 6, 3, 5), (0.0,) * 4, 3,
                      (8, 16, 32), 0),
    "more_requests_than_slots": ((8,) * 5, (3, 4, 2, 5, 3), (0.0,) * 5, 2,
                                 (8,), 2),
    "sampled": ((8, 5, 12, 16), (5, 4, 6, 3), (0.8, 0.0, 1.3, 1.0), 2,
                (8, 16), 1),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_batching_matches_jax(pair, case):
    """Tokens of every request, and which step emitted them, equal
    ganq_tpu's BatchingEngine under mixed lengths and buckets (exact-bucket
    admission draws the first token at prefill), more requests than slots,
    arrivals while others decode, and sampled requests among greedy ones."""
    jcfg, params, tcfg, model = pair
    lens, news, temps, slots, buckets, n_late = _CASES[case]
    prompts = _prompts(len(lens) + slots, lens)
    reqs = list(zip(prompts, news, temps))
    early, late = reqs[:len(reqs) - n_late], reqs[len(reqs) - n_late:]
    want = _drive(JBatching(jcfg, params, slots=slots, max_seq=64,
                            prompt_buckets=buckets), early, late)
    got = _drive(BatchingEngine(tcfg, model, slots=slots, max_seq=64,
                                prompt_buckets=buckets, device="cpu"),
                 early, late)
    assert got == want
    assert all(len(v) == n for v, n in zip(got[0].values(), news))


def test_eos_retires_slot_as_jax(pair):
    """A request retires at the eos id (its slot then serves the next one),
    in both packages alike."""
    jcfg, params, tcfg, model = pair
    p = _prompts(9, (8, 8))
    probe = BatchingEngine(tcfg, model, slots=1, max_seq=64,
                           prompt_buckets=(8,), device="cpu")
    probe.submit(p[0], max_new_tokens=5)
    eos = list(probe.run_all().values())[0][1]
    reqs = [(p[0], 5, 0.0), (p[1], 4, 0.0)]
    want = _drive(JBatching(jcfg, params, slots=1, max_seq=64, eos_id=eos,
                            prompt_buckets=(8,)), reqs)
    got = _drive(BatchingEngine(tcfg, model, slots=1, max_seq=64, eos_id=eos,
                                prompt_buckets=(8,), device="cpu"), reqs)
    assert got == want and got[0][0][-1] == eos and len(got[0][0]) <= 2
    assert len(got[0][1]) == 4           # the freed slot served the next


def test_submit_validation(pair):
    """max_new_tokens < 1 and requests longer than max_seq raise, as in
    ganq_tpu."""
    jcfg, params, tcfg, model = pair
    p = _prompts(2, (8,))[0]
    for eng in (JBatching(jcfg, params, slots=1, max_seq=16),
                BatchingEngine(tcfg, model, slots=1, max_seq=16,
                               device="cpu")):
        with pytest.raises(ValueError):
            eng.submit(p, max_new_tokens=0)
        with pytest.raises(ValueError):
            eng.submit(p, max_new_tokens=9)


def test_batching_matches_static_engine(pair):
    """Greedy batching equals the port's static Engine request by request
    (ganq_tpu's ``_parity_vs_engine``), and the port's Engine equals
    ganq_tpu's, greedy and sampled (top-k, top-p) for the same seeds."""
    jcfg, params, tcfg, model = pair
    prompts = _prompts(5, (6, 9, 12))
    single = Engine(tcfg, model, max_seq=64, device="cpu")
    eng = BatchingEngine(tcfg, model, slots=2, max_seq=64,
                         prompt_buckets=(8, 16), device="cpu")
    ids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    out = eng.run_all()
    for rid, p in zip(ids, prompts):
        assert out[rid] == single.generate(p, max_new_tokens=5)[0].tolist()
    jeng = JEngine(jcfg, params, max_seq=64)
    ids2 = np.stack([prompts[0][:6], prompts[1][:6]])
    for kw in ({}, {"temperature": 0.8, "seed": 3},
               {"temperature": 1.2, "top_k": 7, "seed": 11},
               {"temperature": 1.0, "top_p": 0.9, "seed": 2**31 - 1}):
        np.testing.assert_array_equal(
            single.generate(ids2, max_new_tokens=6, **kw),
            np.asarray(jeng.generate(ids2, max_new_tokens=6, **kw)),
            err_msg=str(kw))


def test_batching_moe_mixtral():
    """The tiny Mixtral of ``tests/test_batching.py`` (4 experts, top-2)
    through the port's batching equals its static engine and ganq_tpu's
    batching (MoE layers run per layer at vector positions)."""
    import transformers

    from ganq_tpu.models import hf_import as jhf

    hf_cfg = transformers.MixtralConfig(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128)
    torch.manual_seed(21)
    hf_model = transformers.MixtralForCausalLM(hf_cfg)
    jcfg, params = jhf.params_from_torch_model(hf_model)
    params = _f32(params)
    tcfg, model = thf.params_from_numpy(hf_cfg.to_dict(),
                                        _flatten_jax(params), device="cpu")
    prompts = _prompts(6, (6, 9, 12))
    reqs = [(p, 5, 0.0) for p in prompts]
    want = _drive(JBatching(jcfg, params, slots=2, max_seq=64,
                            prompt_buckets=(8, 16)), reqs)
    eng = BatchingEngine(tcfg, model, slots=2, max_seq=64,
                         prompt_buckets=(8, 16), device="cpu")
    assert eng._mega_variant is None
    got = _drive(eng, reqs)
    assert got == want
    single = Engine(tcfg, model, max_seq=64, device="cpu")
    for i, p in enumerate(prompts):
        assert got[0][i] == single.generate(p, max_new_tokens=5)[0].tolist()


def test_threaded_batcher_concurrent(pair):
    """Concurrent callers of ThreadedBatcher each get the static engine's
    greedy tokens."""
    _, _, tcfg, model = pair
    prompts = _prompts(7, (8, 8, 8, 8))
    single = Engine(tcfg, model, max_seq=64, device="cpu")
    expected = [single.generate(p, max_new_tokens=4)[0].tolist()
                for p in prompts]
    tb = ThreadedBatcher(tcfg, model, slots=2, max_seq=64, device="cpu")
    results = [None] * len(prompts)

    def worker(i):
        results[i] = tb.generate_ids(prompts[i], max_new_tokens=4)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        tb.shutdown()
    assert results == expected


@pytest.mark.parametrize("variant", ["w4", "w4p", "w8p"])
def test_whole_step_mode_matches_per_layer(variant, monkeypatch):
    """With ``GANQ_MEGASTEP=1`` on the CPU the batching engine decodes every
    slot in one whole step at per-slot positions through the kernels' plain
    versions: kernel 13 ("w4", ``GANQ_W4_PLANE=0``), kernel 14 "w4p", and
    "w8p" on an ``optimize("w8")``-style model (``w8`` layers and a ``w8``
    lm_head, so the unembed folds into the step). Its tokens agree with the
    per-layer mode (``GANQ_MEGASTEP=0``) on at least 0.9 of them (int8
    activations against full-precision ones, as
    ``tests/test_batching.py::test_batching_w4_megastep_fast_path`` holds
    ganq_tpu)."""
    cfg = tsyn.llama_config(hidden=256, inter=512, layers=2, heads=2,
                            kv_heads=1, vocab=512, max_pos=128)
    if variant == "w8p":
        model = tsyn.make_model(cfg, kind="w8", seed=6, device="cpu",
                                dtype=torch.float32, lm_head_kind="w8")
    else:
        model = tsyn.make_model(cfg, kind="uniform", seed=6, device="cpu",
                                dtype=torch.float32)
    monkeypatch.setenv("GANQ_W4_PLANE", "0" if variant == "w4" else "1")
    prompts = _prompts(8, (5, 9, 17, 8))
    runs = {}
    for env in ("1", "0"):
        monkeypatch.setenv("GANQ_MEGASTEP", env)
        eng = BatchingEngine(cfg, model, slots=4, max_seq=64,
                             prompt_buckets=(8, 16, 32), device="cpu")
        assert eng._mega_variant == (variant if env == "1" else None)
        if env == "1":
            assert eng.model is None      # the per-layer model is dropped
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        runs[env] = eng.run_all()
    got, ref = runs["1"], runs["0"]
    assert set(got) == set(ref)
    n_tok = sum(len(v) for v in ref.values())
    n_agree = sum((np.asarray(got[k]) == np.asarray(ref[k])).sum()
                  for k in ref)
    assert n_agree >= 0.9 * n_tok, (got, ref)


def test_unported_variant_raises_at_construction(monkeypatch):
    """Kernel 14's "w2" (a 2-bit uniform model), which earlier slices
    refused at construction, is the batching engine's whole-step variant
    with ``GANQ_MEGASTEP=1``: its pack holds the 2-bit planes, and its
    tokens for three requests on two slots agree with the per-layer
    engine's (``GANQ_MEGASTEP=0``) on at least 90% of the tokens (the int8
    activations of the whole step)."""
    monkeypatch.setenv("GANQ_MEGASTEP", "1")
    cfg = tsyn.llama_config(hidden=512, inter=1024, layers=2, heads=4,
                            kv_heads=2, vocab=256, max_pos=128)
    model = tsyn.make_model(cfg, kind="uniform", bits=2, seed=2,
                            device="cpu", dtype=torch.float32)
    prompts = [np.arange(1, 6), np.arange(7, 16), np.arange(20, 23)]
    out = {}
    for env in ("1", "0"):
        monkeypatch.setenv("GANQ_MEGASTEP", env)
        eng = BatchingEngine(cfg, model, slots=2, max_seq=64, device="cpu")
        assert eng._mega_variant == ("w2" if env == "1" else None)
        if env == "1":
            assert eng._mp is eng._sp.megapack_lb
            assert eng._mp["qkv_pk"].shape[1] == (512 + 2 * 256) // 4
        for p in prompts:
            eng.submit(p, max_new_tokens=4)
        out[env] = eng.run_all()
    n_tok = sum(len(v) for v in out["0"].values())
    n_agree = sum((np.asarray(out["1"][k]) == np.asarray(out["0"][k])).sum()
                  for k in out["0"])
    assert n_agree >= 0.9 * n_tok, out
