"""The port's encoder-decoder family (``configs.whisper_large_v3``,
``models.encdec``, ``attention.cross_attention`` / ``encode_cross_kv``,
``layers.sinusoidal_positions``, ``convert``'s encdec trees and caches)
against the JAX package on the CPU.

The whisper smoke config: 2 encoder layers over 12 stubbed frames
(non-causal), 2 decoder layers (causal self-attention, cross-attention over
the encoder's K/V), LayerNorm, gelu MLPs with biases, sinusoidal positions,
tied embeddings; f32 with both ``attention_impl`` values (helpers and
tolerances in ``_torch_zoo_common``: 1e-4 on logits, caches and gradients).

``sinusoidal_positions`` is not bit for bit JAX's: its sin and cos differ
from XLA:CPU's by one ulp on some elements, and at d_model 1,280 the f32
power ``10000 ** (i / half)`` differs by one ulp at 11 of the 640
frequencies (their inverses at 9); the test counts both exactly (ROADMAP
C.16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jA
from repro.models import encdec as jE
from repro.models import layers as jL
from repro_torch import convert, kernels
from repro_torch.launch import serve
from repro_torch.models import attention as tA
from repro_torch.models import encdec as tE
from repro_torch.models import layers as tL
from repro_torch.models import zoo as tzoo

import _torch_zoo_common as Z

ARCH = "whisper_large_v3"
IMPLS = ["xla", "pallas"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the parallel workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a, b) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


# (d_model, elements that differ, frequencies that differ): the smoke width
# and whisper's, over positions 0 to 1,500 (the encoder's frames and past)
@pytest.mark.parametrize("d,n_diff,bad_freqs", [
    (64, 4726, []), (1280, 110464, [126, 171, 407, 447, 468, 503, 555, 556, 589])])
def test_sinusoidal_positions_gaps_counted(d, n_diff, bad_freqs):
    half = d // 2
    want = np.asarray(jL.sinusoidal_positions(1501, d))
    got = tL.sinusoidal_positions(1501, d).numpy()
    assert got.shape == want.shape == (1501, d) and got.dtype == np.float32
    assert int((got != want).sum()) == n_diff
    # the frequencies: the f32 powers 10000 ** (i / half) one ulp apart at
    # 11 of whisper's 640, their inverses one or two ulps apart at 9
    jpow = np.asarray(10000.0 ** (jnp.arange(half, dtype=jnp.float32) / half))
    tpow = torch.pow(torch.tensor(10000.0), torch.arange(half) / half).numpy()
    assert int((jpow != tpow).sum()) == (11 if bad_freqs else 0)
    assert _ulps(jpow, tpow).max() <= 1
    jinv, tinv = 1.0 / jpow, (1.0 / torch.from_numpy(tpow)).numpy()
    assert np.nonzero(jinv != tinv)[0].tolist() == bad_freqs
    assert _ulps(jinv, tinv)[bad_freqs].tolist() == ([1, 1, 1, 2, 1, 2, 1, 1, 1]
                                                    if bad_freqs else [])
    # elsewhere sin and cos of the same angle, at most one ulp apart
    cols = np.ones(d, bool)
    cols[bad_freqs] = cols[[half + i for i in bad_freqs]] = False
    assert _ulps(got[:, cols], want[:, cols]).max() <= 1
    assert np.abs(got - want).max() <= 3.1e-5
    # the decode form (one position at an offset) is the table's row
    for off in (0, 7, 224, 1500):
        assert np.array_equal(tL.sinusoidal_positions(1, d, off).numpy()[0], got[off])


def test_cross_attention_and_encode_cross_kv_match_jax():
    jcfg, tcfg = Z.cfgs(ARCH)
    jp = jA.attn_params(jcfg, jax.random.key(1))
    rng = np.random.default_rng(2)
    for name in ("bq", "bk", "bv"):   # non-zero biases, so the test sees them
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape, dtype=np.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    enc = rng.standard_normal((2, 12, 64), dtype=np.float32)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    jkv = jA.encode_cross_kv(jcfg, jp, jnp.asarray(enc))
    tkv = tA.encode_cross_kv(tcfg, tp, torch.from_numpy(enc))
    for g, w in zip(tkv, jkv):
        Z.close(g, w, atol=1e-5, rtol=1e-5)
    Z.close(tA.cross_attention(tcfg, tp, torch.from_numpy(x), tkv),
            jA.cross_attention(jcfg, jp, jnp.asarray(x), jkv), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_and_forward_match_jax(impl):
    japi, jparams, tapi, tparams, _ = Z.models(ARCH, impl)
    b = Z.batch(japi.cfg)
    enc = tE.encode(tapi.cfg, tparams, torch.from_numpy(b["frontend_embeds"]))
    Z.close(enc, jax.jit(lambda p, f: jE.encode(japi.cfg, p, f))(
        jparams, jnp.asarray(b["frontend_embeds"])))
    got = tapi.forward(tparams, Z.tb(b))
    assert got.shape == (Z.B, Z.S, japi.cfg.padded_vocab)
    Z.close(got, Z.jitted(japi).forward(jparams, Z.jb(b)))


def _np_caches(jc) -> tuple:
    return ({"k": np.asarray(jc["kv"].k), "v": np.asarray(jc["kv"].v),
             "length": np.asarray(jc["kv"].length)}, tuple(np.asarray(a) for a in jc["cross"]))


def _close_caches(tc, jc):
    got = convert.encdec_caches_to_numpy(tc)
    kv, cross = _np_caches(jc)
    np.testing.assert_array_equal(got["kv"]["length"], kv["length"])
    for f in ("k", "v"):
        np.testing.assert_allclose(got["kv"][f], kv[f], **Z.TOL)
    for g, w in zip(got["cross"], cross):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **Z.TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_caches_and_decode_steps_match_jax(impl):
    """Prefill logits, self-attention caches and cross K/V, then 4 greedy
    decode steps (the sinusoidal offset the cache's length)."""
    japi, jparams, tapi, tparams, _ = Z.models(ARCH, impl)
    jf = Z.jitted(japi)
    b = Z.batch(japi.cfg, seed=5)
    max_len = Z.S + Z.GEN + 1
    jlog, jc = jf.prefill(jparams, Z.jb(b), max_len)
    tlog, tc = tapi.prefill(tparams, Z.tb(b), max_len)
    Z.close(tlog, jlog)
    _close_caches(tc, jc)
    for _ in range(Z.GEN):
        nxt = np.array(jnp.argmax(jlog[:, :, : japi.cfg.vocab_size], -1), np.int32)
        jlog, jc = jf.decode_step(jparams, jc, jnp.asarray(nxt))
        tlog, tc = tapi.decode_step(tparams, tc, torch.from_numpy(nxt).long())
        Z.close(tlog, jlog)
    _close_caches(tc, jc)
    assert tc["kv"][0].length == Z.S + Z.GEN


def test_decode_from_jax_caches_and_caches_round_trip():
    japi, jparams, tapi, tparams, _ = Z.models(ARCH)
    jf = Z.jitted(japi)
    b = Z.batch(japi.cfg, seed=6)
    jlog, jc = jf.prefill(jparams, Z.jb(b), Z.S + 3)
    kv, cross = _np_caches(jc)
    tc = convert.encdec_caches_from_numpy(tapi.cfg, kv, cross, device="cpu")
    back = convert.encdec_caches_to_numpy(tc)
    for f in kv:
        np.testing.assert_array_equal(back["kv"][f], kv[f])
    for g, w in zip(back["cross"], cross):
        np.testing.assert_array_equal(g, w)
    nxt = np.array(jnp.argmax(jlog[:, :, : japi.cfg.vocab_size], -1), np.int32)
    jlog2, _ = jf.decode_step(jparams, jc, jnp.asarray(nxt))
    tlog2, _ = tapi.decode_step(tparams, tc, torch.from_numpy(nxt).long())
    Z.close(tlog2, jlog2)


def test_precompute_cross_and_init_decode_state_match_jax():
    japi, jparams, tapi, tparams, _ = Z.models(ARCH)
    cfg = japi.cfg
    enc = np.random.default_rng(7).standard_normal((Z.B, cfg.encoder_seq, 64), dtype=np.float32)
    want = jE.precompute_cross(cfg, jparams, jnp.asarray(enc))
    got = tE.precompute_cross(tapi.cfg, tparams, torch.from_numpy(enc))
    assert len(got) == cfg.num_layers
    for i, (k, v) in enumerate(got):
        Z.close(k, want[0][i], atol=1e-5, rtol=1e-5)
        Z.close(v, want[1][i], atol=1e-5, rtol=1e-5)
    jc = jE.init_decode_state(cfg, Z.B, 12, 3)
    tc = tapi.init_decode_state(Z.B, 12, 3, device="cpu")
    got, (kv, cross) = convert.encdec_caches_to_numpy(tc), _np_caches(jc)
    for f in kv:
        np.testing.assert_array_equal(got["kv"][f], kv[f])
    for g, w in zip(got["cross"], cross):
        np.testing.assert_array_equal(g, w)


def test_greedy_tokens_match_jax():
    Z.greedy_tokens_match(ARCH)


def test_teacher_forced_decode_matches_forward():
    """Decode over the self-attention cache and the precomputed cross K/V
    (as ``tests/test_smoke_archs.py`` builds it) reproduces the forward."""
    _, tcfg = Z.cfgs(ARCH, "pallas")
    tapi = tzoo.build(tcfg)
    params = tapi.init_params(0, device="cpu")
    b = Z.tb(Z.batch(tcfg, seed=3))
    full = tapi.forward(params, b)
    caches = tapi.init_decode_state(Z.B, max_len=Z.S + 2, device="cpu")
    caches["cross"] = tE.precompute_cross(tcfg, params,
                                          tE.encode(tcfg, params, b["frontend_embeds"]))
    outs = []
    for t in range(Z.S):
        logits, caches = tapi.decode_step(params, caches, b["tokens"][:, t:t + 1])
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, **Z.TOL)


def test_loss_and_grads_match_jax():
    Z.loss_and_grads_match(ARCH)


def test_convert_round_trip_encdec_tree():
    params = Z.params_round_trip(ARCH, "bfloat16")
    assert len(params["enc"]) == 2 == len(params["dec"]) and "enc_norm" in params
    assert set(params["dec"][0]) == {"ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp"}


def test_serve_main_runs_on_cpu(capsys):
    argv = ["--arch", ARCH, "--preset", "smoke", "--prompts", "2", "--prompt-len", "8",
            "--gen", "3"]
    kernels.reset_launches()
    gen = serve.main(argv, device="cpu")
    assert gen.shape == (2, 4) and ((gen >= 0) & (gen < 512)).all()
    assert "[serve] decoded 3 tokens x 2 seqs" in capsys.readouterr().out
    assert kernels.launches()["flash_attention"] == 0
    np.testing.assert_array_equal(gen, serve.main(argv, device="cpu"))
