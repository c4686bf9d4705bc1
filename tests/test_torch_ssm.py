"""The port's Mamba2 serving path (``configs.mamba2_370m``, ``models.ssm``,
``models.mamba_lm``, the ssm route of ``models.zoo``, ``launch.serve`` on
the default arch and ``convert``'s SSM caches) against the JAX package on
the CPU.

Each test takes the mamba2 smoke config (3 layers, d_model 64, 8 heads of
16, state 16, chunk 8) in float32 or bfloat16 compute, draws the parameters
with JAX's ``init_params``, perturbs ``A_log``, ``dt_bias``, ``D``,
``norm_scale`` and ``conv_b`` with seeded numpy noise (JAX's init makes them
constant, which would hide an indexing fault), and carries them across with
``convert.lm_params_from_numpy``; tokens are numpy draws fed to both. On CPU
tensors the port's ``ssd_chunked`` is the twin of JAX's jnp form.
Tolerances (absolute and relative): 1e-5 in f32 (sums in another order);
5e-2 in bf16 (the two frameworks round bf16 at other places), the bf16
tolerance of ``tests/test_kernels.py`` and ``tests/test_smoke_archs.py``.
One exception: the f32 SSM state of a bf16 model past its first layer sums
inputs that two frameworks rounded apart through earlier layers, with
cancellation, so there it is held to JAX's bf16 state by JAX's own
distance from its f32 state (the port's bf16 state may be no farther from
JAX's than JAX's is from exact), not elementwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import ssm as jS
from repro.models import zoo as jzoo
from repro.train.steps import make_decode_step as j_make_decode_step
from repro_torch import config as tconfig
from repro_torch import convert, kernels
from repro_torch.launch import serve
from repro_torch.models import ssm as tS
from repro_torch.models import zoo as tzoo

ARCH = "mamba2_370m"
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DTYPES = ["float32", "bfloat16"]
B, S, GEN = 2, 16, 4


def _cfgs(dtype="float32", **kw):
    over = dict(dtype=dtype, **kw)
    return (dataclasses.replace(jconfig.get_smoke_config(ARCH), **over),
            dataclasses.replace(tconfig.get_smoke_config(ARCH), **over))


def _perturb(tree, seed=0):
    """Seeded noise on the leaves JAX initializes to constants."""
    rng = np.random.default_rng(seed)
    ssm = tree["blocks"]["ssm"]
    noise = {"A_log": 0.5, "dt_bias": 0.5, "D": 0.3, "norm_scale": 0.2, "conv_b": 0.2}
    for k, scale in noise.items():
        a = np.asarray(ssm[k])
        ssm[k] = (a + rng.standard_normal(a.shape) * scale).astype(a.dtype)
    return tree


def _models(dtype="float32", **kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    japi, tapi = jzoo.build(jcfg), tzoo.build(tcfg)
    tree = _perturb(jax.tree_util.tree_map(np.asarray, japi.init_params(jax.random.key(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = convert.lm_params_from_numpy(tcfg, tree, device="cpu")
    return japi, jparams, tapi, tparams


def _tokens(cfg, seq=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, seq), dtype=np.int32)


def _close(got, want, dtype="float32"):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _check_caches(tcaches, jcaches, dtype, jcaches32=None):
    """Caches against JAX's; in bf16, each layer's state against JAX's by
    JAX's own bf16-to-f32 distance (``jcaches32``: JAX's f32 run)."""
    assert len(tcaches) == jcaches.state.shape[0]
    for i, c in enumerate(tcaches):
        assert c.state.dtype == torch.float32
        assert c.conv.dtype == getattr(torch, dtype)
        _close(c.conv, jcaches.conv[i], dtype)
        if jcaches32 is None:
            _close(c.state, jcaches.state[i], dtype)
            continue
        want = np.asarray(jcaches.state[i])
        gap = np.abs(want - np.asarray(jcaches32.state[i])).max()
        assert np.abs(c.state.numpy() - want).max() <= gap, i


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
def test_config_equals_jax_field_for_field():
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfig, get)(ARCH), getattr(tconfig, get)(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.padded_vocab, t.ssm_d_inner, t.ssm_heads, t.param_count()) == \
            (j.padded_vocab, j.ssm_d_inner, j.ssm_heads, j.param_count())
    full = tconfig.get_config("mamba2-370m")
    assert (full.num_layers, full.d_model, full.ssm_d_inner, full.ssm_heads,
            full.ssm_state, full.padded_vocab) == (48, 1024, 2048, 32, 128, 50432)
    assert round(full.param_count() / 1e6, 1) == 368.2


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def _block_inputs(dtype, seq=S, seed=1):
    japi, jparams, tapi, tparams = _models(dtype)
    u = np.random.default_rng(seed).standard_normal((B, seq, japi.cfg.d_model),
                                                    dtype=np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = _layer(jparams["blocks"]["ssm"], 1)
    tp = tparams["blocks"][1]["ssm"]
    return japi.cfg, tapi.cfg, jp, tp, jnp.asarray(u, jdt), torch.from_numpy(u).to(tdt)


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_jax(dtype):
    jcfg, tcfg, jp, tp, ju, tu = _block_inputs(dtype)
    conv_dim = jcfg.ssm_d_inner + 2 * jcfg.ssm_groups * jcfg.ssm_state
    xbc = np.random.default_rng(2).standard_normal((B, S, conv_dim), dtype=np.float32)
    got = tS._causal_conv(tcfg, tp, torch.from_numpy(xbc).to(tu.dtype))
    _close(got, jS._causal_conv(jcfg, jp, jnp.asarray(xbc, ju.dtype)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_ssm_matches_jax(dtype):
    jcfg, tcfg, jp, tp, ju, tu = _block_inputs(dtype)
    out, cache = tS.apply_ssm(tcfg, tp, tu)
    jout, jcache = jS.apply_ssm(jcfg, jp, ju)
    assert out.shape == tu.shape and out.dtype == tu.dtype
    _close(out, jout, dtype)
    _close(cache.conv, jcache.conv, dtype)
    _close(cache.state, jcache.state, dtype)
    assert cache.conv.is_contiguous() and cache.conv.shape == (B, jcfg.ssm_conv_width - 1,
                                                               jcache.conv.shape[-1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_ssm_matches_jax(dtype):
    jcfg, tcfg, jp, tp, ju, tu = _block_inputs(dtype)
    _, jcache = jS.apply_ssm(jcfg, jp, ju)
    _, tcache = tS.apply_ssm(tcfg, tp, tu)
    for t in range(3):
        step = np.random.default_rng(10 + t).standard_normal((B, 1, jcfg.d_model),
                                                             dtype=np.float32)
        jout, jcache = jS.decode_ssm(jcfg, jp, jnp.asarray(step, ju.dtype), jcache)
        tout, tcache = tS.decode_ssm(tcfg, tp, torch.from_numpy(step).to(tu.dtype), tcache)
        _close(tout, jout, dtype)
    _close(tcache.conv, jcache.conv, dtype)
    _close(tcache.state, jcache.state, dtype)


def test_softplus_has_no_threshold():
    v = torch.tensor([-30.0, -1.0, 0.0, 5.0, 19.0, 21.0, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(v.numpy())))
    np.testing.assert_allclose(tS._softplus(v).numpy(), want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(dtype):
    japi, jparams, tapi, tparams = _models(dtype)
    toks = _tokens(japi.cfg)
    got = tapi.forward(tparams, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, S, japi.cfg.padded_vocab)
    _close(got, japi.forward(jparams, {"tokens": jnp.asarray(toks)}), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_from_jax_caches_match_jax(dtype):
    """Prefill logits and caches; then decode steps of the port from JAX's
    prefill caches (carried across by ``ssm_caches_from_numpy``)."""
    japi, jparams, tapi, tparams = _models(dtype)
    j32 = jzoo.build(dataclasses.replace(japi.cfg, dtype="float32")) \
        if dtype == "bfloat16" else None
    toks = _tokens(japi.cfg, seed=2)
    jtoks = {"tokens": jnp.asarray(toks)}
    jlog, jcaches = japi.prefill(jparams, jtoks, S + GEN + 1)
    jc32 = j32.prefill(jparams, jtoks, S + GEN + 1)[1] if j32 else None
    tlog, tcaches = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks).long()},
                                 S + GEN + 1)
    assert tlog.shape == (B, 1, japi.cfg.padded_vocab)
    _close(tlog, jlog, dtype)
    _check_caches(tcaches, jcaches, dtype, jc32)
    caches = convert.ssm_caches_from_numpy(tapi.cfg, np.asarray(jcaches.conv),
                                           np.asarray(jcaches.state), device="cpu")
    nxt = np.random.default_rng(3).integers(0, japi.cfg.vocab_size, (GEN, B, 1),
                                            dtype=np.int32)
    for t in range(GEN):
        jlog, jcaches = japi.decode_step(jparams, jcaches, jnp.asarray(nxt[t]))
        if j32:
            jc32 = j32.decode_step(jparams, jc32, jnp.asarray(nxt[t]))[1]
        tlog, caches = tapi.decode_step(tparams, caches, torch.from_numpy(nxt[t]).long())
        _close(tlog, jlog, dtype)
    _check_caches(caches, jcaches, dtype, jc32)


def test_greedy_tokens_match_jax():
    japi, jparams, tapi, tparams = _models()
    toks = _tokens(japi.cfg, seed=11)
    jlog, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, S + GEN + 1)
    jt = jnp.argmax(jlog[:, :, : japi.cfg.vocab_size], -1).astype(jnp.int32)
    jstep = jax.jit(j_make_decode_step(japi))
    jout = [np.asarray(jt)]
    for _ in range(GEN):
        jt, jc = jstep(jparams, jc, jt)
        jout.append(np.asarray(jt))
    res = serve.serve_batch(tapi, tparams, {"tokens": torch.from_numpy(toks).long()}, GEN)
    np.testing.assert_array_equal(res.tokens, np.concatenate(jout, axis=1))
    assert res.prefill_launches["ssd_scan"] == 0 == res.decode_launches["ssd_scan"]


@pytest.mark.parametrize("seq", [8, 24])
def test_teacher_forced_decode_matches_forward(seq):
    """As ``tests/test_smoke_archs.py`` checks JAX (bf16 compute, 5e-2):
    decoding one token at a time reproduces the forward's logits; at 24
    tokens the forward carries its state over three chunks."""
    _, tcfg = _cfgs("bfloat16")
    tapi = tzoo.build(tcfg)
    params = tapi.init_params(0, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, seq=seq, seed=4)).long()
    full = tapi.forward(params, {"tokens": toks})
    caches = tapi.init_decode_state(B, max_len=seq + 4, device="cpu")
    outs = []
    for t in range(seq):
        logits, caches = tapi.decode_step(params, caches, toks[:, t:t + 1])
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1).float(), full.float(), atol=5e-2,
                               rtol=5e-2)


def test_init_decode_state_is_one_empty_cache_a_layer():
    _, tcfg = _cfgs("bfloat16")
    caches = tzoo.build(tcfg).init_decode_state(3, max_len=99, device="cpu")
    assert len(caches) == tcfg.num_layers
    conv_dim = tcfg.ssm_d_inner + 2 * tcfg.ssm_groups * tcfg.ssm_state
    for c in caches:
        assert c.conv.shape == (3, tcfg.ssm_conv_width - 1, conv_dim)
        assert c.conv.dtype == torch.bfloat16 and not c.conv.any()
        assert c.state.shape == (3, tcfg.ssm_heads, tcfg.ssm_state, tcfg.ssm_head_dim)
        assert c.state.dtype == torch.float32 and not c.state.any()


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_round_trip(param_dtype):
    jcfg, tcfg = _cfgs(param_dtype=param_dtype)
    tree = _perturb(jax.tree_util.tree_map(
        np.asarray, jzoo.build(jcfg).init_params(jax.random.key(4))))
    params = convert.lm_params_from_numpy(tcfg, tree, device="cpu")
    assert "unembed" not in params and len(params["blocks"]) == tcfg.num_layers
    assert set(params["blocks"][0]) == {"ln", "ssm"}
    assert params["blocks"][2]["ssm"]["A_log"].dtype == getattr(torch, param_dtype)
    back = convert.lm_params_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    again = convert.lm_params_from_numpy(tcfg, back, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_caches_round_trip(dtype):
    japi, jparams, tapi, tparams = _models(dtype)
    toks = _tokens(japi.cfg, seed=5)
    _, jcaches = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, S)
    caches = convert.ssm_caches_from_numpy(tapi.cfg, np.asarray(jcaches.conv),
                                           np.asarray(jcaches.state), device="cpu")
    assert len(caches) == japi.cfg.num_layers
    assert caches[0].conv.dtype == getattr(torch, dtype)
    back = convert.ssm_caches_to_numpy(caches)
    np.testing.assert_array_equal(back["conv"], np.asarray(jcaches.conv, np.float32))
    np.testing.assert_array_equal(back["state"], np.asarray(jcaches.state))
    again = convert.ssm_caches_from_numpy(tapi.cfg, back["conv"], back["state"],
                                          device="cpu")
    for a, b in zip(again, caches):
        assert torch.equal(a.conv, b.conv) and torch.equal(a.state, b.state)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
def test_serve_main_serves_the_default_arch_on_cpu(capsys):
    kernels.reset_launches()
    args = ["--prompts", "2", "--prompt-len", "16", "--gen", "3"]
    gen = serve.main(args, device="cpu")
    assert gen.shape == (2, 4)
    assert ((gen >= 0) & (gen < tconfig.get_smoke_config(ARCH).vocab_size)).all()
    out = capsys.readouterr().out
    assert "[serve] prefill:" in out and "[serve] decoded 3 tokens x 2 seqs" in out
    assert f"[serve] first sequence: {gen[0].tolist()}" in out
    assert kernels.launches()["ssd_scan"] == 0
    np.testing.assert_array_equal(gen, serve.main(args, device="cpu"))
