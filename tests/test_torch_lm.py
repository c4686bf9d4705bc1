"""The port's dense LM serving path (``repro_torch.config``, ``models.layers``,
``models.attention``, ``models.transformer``, ``models.zoo``,
``train.steps``, ``launch.serve`` and ``convert``'s LM params) against the
JAX package on the CPU.

Each model test takes a smoke config (``stablelm_12b``: GQA with hd 16;
``granite_20b``: MQA; ``command_r_35b``: tied embeddings with hd 8) in
float32, draws the parameters with JAX's ``init_params``, and carries them
across with ``convert.lm_params_from_numpy``; tokens are numpy draws fed to
both. JAX's ``attention_impl="pallas"`` runs its Pallas kernel in interpret
mode; the port's runs B4's plain version on CPU tensors. Tolerances: 1e-4
(absolute and relative) on logits and caches, f32 sums taken in other
orders by two BLAS libraries through two or three layers; 1e-5 on single
layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import attention as jA
from repro.models import layers as jL
from repro.models import zoo as jzoo
from repro.train.steps import make_decode_step as j_make_decode_step
from repro_torch import config as tconfig
from repro_torch import convert, kernels
from repro_torch.launch import serve
from repro_torch.models import attention as tA
from repro_torch.models import layers as tL
from repro_torch.models import zoo as tzoo
from repro_torch.train.steps import make_decode_step, make_prefill_step

ARCHS = ["stablelm_12b", "granite_20b", "command_r_35b"]
DENSE = ARCHS + ["mistral_large_123b"]
IMPLS = ["xla", "pallas"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, GEN = 2, 16, 4


def _cfgs(arch, impl="xla", **kw):
    over = dict(dict(dtype="float32", attention_impl=impl), **kw)
    return (dataclasses.replace(jconfig.get_smoke_config(arch), **over),
            dataclasses.replace(tconfig.get_smoke_config(arch), **over))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(arch, impl="xla", **kw):
    jcfg, tcfg = _cfgs(arch, impl, **kw)
    japi, tapi = jzoo.build(jcfg), tzoo.build(tcfg)
    jparams = japi.init_params(jax.random.key(0))
    tparams = convert.lm_params_from_numpy(tcfg, _np(jparams), device="cpu")
    return japi, jparams, tapi, tparams


def _tokens(cfg, seq=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, seq), dtype=np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_config_equals_jax_field_for_field(arch):
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfig, get)(arch), getattr(tconfig, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.padded_vocab, t.resolved_head_dim, t.param_count()) == \
            (j.padded_vocab, j.resolved_head_dim, j.param_count())


def test_registry_equals_jax_and_unported_families_raise():
    assert tconfig.ARCH_IDS == jconfig.ARCH_IDS
    assert tconfig.ALIASES == jconfig.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    assert tconfig.get_config("stablelm-12b") == tconfig.get_config("stablelm_12b")
    for arch in set(tconfig.ARCH_IDS) - set(DENSE) - {"mamba2_370m"}:
        with pytest.raises(NotImplementedError, match="ROADMAP A.11"):
            tconfig.get_config(arch)
    moe = dataclasses.replace(tconfig.get_smoke_config("stablelm_12b"), family="moe")
    with pytest.raises(NotImplementedError, match="A.11b"):
        tzoo.build(moe)
    experts = dataclasses.replace(tconfig.get_smoke_config("stablelm_12b"), num_experts=2)
    with pytest.raises(NotImplementedError, match="A.11b"):
        tzoo.build(experts).init_params(0, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    scale = rng.standard_normal(64, dtype=np.float32) * 0.1
    got = tL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    _close(got, jL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hd,sections", [(160, ()), (16, ()), (32, (4, 6, 6))])
def test_apply_rope_matches_jax(hd, sections):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 12, 3, hd), dtype=np.float32)
    shape = (3, 2, 12) if sections else (2, 12)
    pos = rng.integers(0, 64, shape).astype(np.int32)
    got = tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(), 1e6, sections)
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    _close(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_mlp_matches_jax(act):
    jcfg, tcfg = _cfgs("stablelm_12b", act=act, use_bias=act == "gelu")
    jp = jL.mlp_params(jcfg, jax.random.key(2), 64, 128)
    if "bi" in jp:  # non-zero biases, so the test sees them
        jp["bi"] = jax.random.normal(jax.random.key(3), (128,))
        jp["bo"] = jax.random.normal(jax.random.key(4), (64,))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(5).standard_normal((2, 7, 64), dtype=np.float32)
    _close(tL.apply_mlp(tcfg, tp, torch.from_numpy(x)),
           jL.apply_mlp(jcfg, jp, jnp.asarray(x)), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def test_sdpa_with_k_valid_matches_jax():
    jcfg, tcfg = _cfgs("stablelm_12b")
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 1, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 24, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 24, 2, 16), dtype=np.float32)
    valid = rng.random((2, 24)) < 0.6
    valid[:, 0] = True
    got = tA.sdpa(tcfg, *map(torch.from_numpy, (q, k, v)), causal=False,
                  k_valid=torch.from_numpy(valid))
    want = jA.sdpa(jcfg, *map(jnp.asarray, (q, k, v)), causal=False,
                   k_valid=jnp.asarray(valid))
    _close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_chunked_sdpa_matches_sdpa(causal, window):
    _, tcfg = _cfgs("stablelm_12b")
    g = torch.Generator().manual_seed(7)
    q = torch.randn(2, 64, 4, 16, generator=g)
    k = torch.randn(2, 64, 2, 16, generator=g)
    v = torch.randn(2, 64, 2, 16, generator=g)
    got = tA.chunked_sdpa(tcfg, q, k, v, causal=causal, window=window, block_q=16,
                          block_k=32)
    want = tA.sdpa(tcfg, q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_kv_replication_matches_jax():
    jcfg, tcfg = _cfgs("granite_20b", kv_replication=2)
    jp = jA.attn_params(jcfg, jax.random.key(8))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(9).standard_normal((2, 5, 64), dtype=np.float32)
    got = tA._project_qkv(tcfg, tp, torch.from_numpy(x), torch.from_numpy(x))
    want = jA._project_qkv(jcfg, jp, jnp.asarray(x), jnp.asarray(x))
    assert got[1].shape == (2, 5, 2, 16)
    for g_, w_ in zip(got, want):
        _close(g_, w_, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, impl):
    japi, jparams, tapi, tparams = _models(arch, impl)
    toks = _tokens(japi.cfg)
    got = tapi.forward(tparams, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, S, japi.cfg.padded_vocab)
    _close(got, japi.forward(jparams, {"tokens": jnp.asarray(toks)}))


def _check_caches(tcaches, jcaches, length):
    assert len(tcaches) == jcaches.k.shape[0]
    for i, c in enumerate(tcaches):
        assert c.length == length == int(jcaches.length[i])
        _close(c.k, jcaches.k[i])
        _close(c.v, jcaches.v[i])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_jax(arch, impl):
    japi, jparams, tapi, tparams = _models(arch, impl)
    toks = _tokens(japi.cfg)
    max_len = S + GEN + 1
    jlog, jcaches = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
    tlog, tcaches = make_prefill_step(tapi, max_len)(
        tparams, {"tokens": torch.from_numpy(toks).long()})
    assert tlog.shape == (B, 1, japi.cfg.padded_vocab)
    _close(tlog, jlog)
    _check_caches(tcaches, jcaches, S)
    nxt = np.array(jnp.argmax(jlog[:, :, : japi.cfg.vocab_size], -1), np.int32)
    jlog2, jcaches2 = japi.decode_step(jparams, jcaches, jnp.asarray(nxt))
    tlog2, tcaches2 = tapi.decode_step(tparams, tcaches, torch.from_numpy(nxt).long())
    _close(tlog2, jlog2)
    _check_caches(tcaches2, jcaches2, S + 1)


def test_sliding_window_ring_cache_matches_jax():
    """Prefill past the window keeps a ring of its last W keys; decode writes
    the next token into slot pos % W."""
    japi, jparams, tapi, tparams = _models("stablelm_12b", "pallas", sliding_window=8)
    toks = _tokens(japi.cfg, seq=20)
    jlog, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, 24)
    tlog, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks).long()}, 24)
    _close(tlog, jlog)
    _check_caches(tc, jc, 20)
    assert tc[0].k.shape[1] == 8
    for _ in range(3):
        nxt = np.array(jnp.argmax(jlog[:, :, : japi.cfg.vocab_size], -1), np.int32)
        jlog, jc = japi.decode_step(jparams, jc, jnp.asarray(nxt))
        tlog, tc = tapi.decode_step(tparams, tc, torch.from_numpy(nxt).long())
        _close(tlog, jlog)
    _check_caches(tc, jc, 23)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(arch):
    japi, jparams, tapi, tparams = _models(arch, "pallas")
    toks = _tokens(japi.cfg, seed=11)
    max_len = S + GEN + 1
    jlog, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
    jt = jnp.argmax(jlog[:, :, : japi.cfg.vocab_size], -1).astype(jnp.int32)
    jstep = jax.jit(j_make_decode_step(japi))
    jout = [np.asarray(jt)]
    for _ in range(GEN):
        jt, jc = jstep(jparams, jc, jt)
        jout.append(np.asarray(jt))
    res = serve.serve_batch(tapi, tparams, {"tokens": torch.from_numpy(toks).long()}, GEN)
    np.testing.assert_array_equal(res.tokens, np.concatenate(jout, axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_forward(arch):
    """As ``tests/test_smoke_archs.py`` checks JAX: decode one token at a time
    over the cache reproduces the forward's logits (same params, tokens)."""
    _, tcfg = _cfgs(arch, "pallas")
    tapi = tzoo.build(tcfg)
    params = tapi.init_params(0, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, seq=8, seed=3)).long()
    full = tapi.forward(params, {"tokens": toks})
    caches = tapi.init_decode_state(B, max_len=12, device="cpu")
    outs = []
    step = make_decode_step(tapi)
    for t in range(8):
        logits, caches = tapi.decode_step(params, caches, toks[:, t:t + 1])
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, **TOL)
    nxt, _ = step(params, caches, toks[:, :1])
    assert nxt.shape == (B, 1) and int(nxt.max()) < tcfg.vocab_size


def test_precast_casts_once_and_keeps_the_numbers():
    _, tcfg = _cfgs("stablelm_12b", dtype="bfloat16")
    tapi = tzoo.build(tcfg)
    params = tapi.init_params(1, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, seq=8)).long()
    once = tzoo.build(dataclasses.replace(tcfg, cast_params_once=True))
    cast = tzoo.precast(once.cfg, params)
    assert cast["blocks"][0]["mlp"]["wg"].dtype == torch.bfloat16
    assert params["blocks"][0]["mlp"]["wg"].dtype == torch.float32
    assert torch.equal(once.forward(params, {"tokens": toks}),
                       tapi.forward(params, {"tokens": toks}))


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_convert_round_trip(param_dtype):
    jcfg, tcfg = _cfgs("command_r_35b", param_dtype=param_dtype)
    tree = _np(jzoo.build(jcfg).init_params(jax.random.key(4)))
    params = convert.lm_params_from_numpy(tcfg, tree, device="cpu")
    assert "unembed" not in params and len(params["blocks"]) == tcfg.num_layers
    assert params["blocks"][1]["attn"]["wq"].dtype == getattr(torch, param_dtype)
    back = convert.lm_params_to_numpy(params)
    flat_t, _ = jax.tree_util.tree_flatten(back)
    flat_j, _ = jax.tree_util.tree_flatten(tree)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    again = convert.lm_params_from_numpy(tcfg, back, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
SMOKE_ARGS = ["--arch", "stablelm_12b", "--preset", "smoke", "--prompts", "2",
              "--prompt-len", "8", "--gen", "3"]


def test_serve_main_runs_on_cpu(capsys):
    kernels.reset_launches()
    gen = serve.main(SMOKE_ARGS, device="cpu")
    assert gen.shape == (2, 4)
    assert ((gen >= 0) & (gen < 512)).all()
    out = capsys.readouterr().out
    assert "[serve] prefill:" in out and "[serve] decoded 3 tokens x 2 seqs" in out
    assert f"[serve] first sequence: {gen[0].tolist()}" in out
    assert kernels.launches()["flash_attention"] == 0
    again = serve.main(SMOKE_ARGS, device="cpu")
    np.testing.assert_array_equal(gen, again)


def test_serve_counts_launches_by_phase_on_cpu():
    _, tcfg = _cfgs("stablelm_12b", "pallas")
    tapi = tzoo.build(tcfg)
    res = serve.serve_batch(tapi, tapi.init_params(0, device="cpu"),
                            {"tokens": torch.zeros((2, 4), dtype=torch.long)}, 2)
    assert res.tokens.shape == (2, 3)
    assert res.prefill_launches["flash_attention"] == 0 == \
        res.decode_launches["flash_attention"]


@pytest.mark.parametrize("extra,telemetry", [
    (["--telemetry-dir", "DIR"], None), (["--telemetry-stdout"], None),
    ([], "handle")])
def test_serve_telemetry_raises(extra, telemetry, tmp_path, capsys):
    """Serving telemetry, once refused, now writes JAX's records: a
    ``mode="serve"`` run header, then one ``kind="query"`` record per prompt
    with cumulative ``tokens_served``, through ``--telemetry-dir`` (a JSONL
    that passes ``benchmarks/check_telemetry.py``), ``--telemetry-stdout``
    or a handle passed in."""
    import importlib.util
    import json
    import pathlib

    from repro_torch.obs import MemorySink, Telemetry

    extra = [str(tmp_path) if a == "DIR" else a for a in extra]
    mem = MemorySink() if telemetry == "handle" else None
    tel = Telemetry([mem]) if mem is not None else None
    gen = serve.main(SMOKE_ARGS + extra, telemetry=tel, device="cpu")
    out = capsys.readouterr().out
    if mem is not None:
        recs = list(mem.records)
    elif "--telemetry-stdout" in extra:
        recs = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
                if line.startswith("[obs] ")]
    else:
        path = tmp_path / "telemetry.jsonl"
        spec = importlib.util.spec_from_file_location(
            "check_telemetry", pathlib.Path(__file__).resolve().parents[1]
            / "benchmarks" / "check_telemetry.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.check_file(path) == []
        recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert recs[0]["kind"] == "run" and recs[0]["mode"] == "serve"
    queries = [r for r in recs if r["kind"] == "query"]
    prompts = int(SMOKE_ARGS[SMOKE_ARGS.index("--prompts") + 1])
    assert [q["query"] for q in queries] == list(range(prompts))
    assert [q["tokens_served"] for q in queries] == \
        [gen.shape[1] * (i + 1) for i in range(prompts)]
    assert all(q["gen_tokens"] == gen.shape[1] and q["prefill_s"] >= 0 for q in queries)
