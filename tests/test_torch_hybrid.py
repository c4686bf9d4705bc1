"""The port's hybrid family (``configs.zamba2_2p7b``, ``models.hybrid``,
``convert``'s hybrid trees and caches) against the JAX package on the CPU.

The zamba2 smoke config: 4 Mamba2 layers (d_model 64, 8 heads of 16, state
16, chunk 8) in 2 groups, each followed by the ONE shared attention + MLP
block (4 heads of 16), in f32 with both ``attention_impl`` values (helpers
and tolerances in ``_torch_zoo_common``: 1e-4 on logits, caches and
gradients, 1e-5 on the loss). On CPU tensors the port's ``ssd_chunked`` is
the twin of JAX's jnp form and B4 its plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import hybrid as jH
from repro_torch import convert, kernels
from repro_torch.launch import serve
from repro_torch.models import hybrid as tH
from repro_torch.models import zoo as tzoo

import _torch_zoo_common as Z

ARCH = "zamba2_2p7b"
IMPLS = ["xla", "pallas"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the parallel workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_caches(jc) -> dict:
    """JAX's hybrid prefill / decode state as numpy, convert's layout."""
    return {"ssm": {"conv": np.asarray(jc["ssm"].conv), "state": np.asarray(jc["ssm"].state)},
            "kv": {"k": np.asarray(jc["kv"].k), "v": np.asarray(jc["kv"].v),
                   "length": np.asarray(jc["kv"].length)}}


def _close_caches(tc, jc):
    got, want = convert.hybrid_caches_to_numpy(tc), _np_caches(jc)
    np.testing.assert_array_equal(got["kv"]["length"], want["kv"]["length"])
    for part, field in (("ssm", "conv"), ("ssm", "state"), ("kv", "k"), ("kv", "v")):
        assert got[part][field].shape == want[part][field].shape
        np.testing.assert_allclose(got[part][field], want[part][field], **Z.TOL)


def test_params_tree_shares_one_block():
    _, _, _, tparams, tree = Z.models(ARCH)
    cfg = Z.cfgs(ARCH)[1]
    assert len(tparams["mamba"]) == cfg.num_layers == 4 and tH._groups(cfg) == 2
    assert set(tparams["shared"]) == {"ln1", "attn", "ln2", "mlp"}
    assert tparams["shared"]["attn"]["wq"].shape == tree["shared"]["attn"]["wq"].shape
    with pytest.raises(ValueError, match="attn_every"):
        tH._groups(Z.cfgs(ARCH, attn_every=3)[1])


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(impl):
    japi, jparams, tapi, tparams, _ = Z.models(ARCH, impl)
    b = Z.batch(japi.cfg)
    got = tapi.forward(tparams, Z.tb(b))
    assert got.shape == (Z.B, Z.S, japi.cfg.padded_vocab)
    Z.close(got, Z.jitted(japi).forward(jparams, Z.jb(b)))


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_caches_and_decode_steps_match_jax(impl):
    """Prefill logits, SSM caches [G][attn_every] and the per-invocation KV
    caches, then 4 greedy decode steps, logits and caches each step."""
    japi, jparams, tapi, tparams, _ = Z.models(ARCH, impl)
    jf = Z.jitted(japi)
    b = Z.batch(japi.cfg, seed=5)
    max_len = Z.S + Z.GEN + 1
    jlog, jc = jf.prefill(jparams, Z.jb(b), max_len)
    tlog, tc = tapi.prefill(tparams, Z.tb(b), max_len)
    assert len(tc["ssm"]) == len(tc["kv"]) == 2 and len(tc["ssm"][0]) == 2
    Z.close(tlog, jlog)
    _close_caches(tc, jc)
    for _ in range(Z.GEN):
        nxt = np.array(jnp.argmax(jlog[:, :, : japi.cfg.vocab_size], -1), np.int32)
        jlog, jc = jf.decode_step(jparams, jc, jnp.asarray(nxt))
        tlog, tc = tapi.decode_step(tparams, tc, torch.from_numpy(nxt).long())
        Z.close(tlog, jlog)
    _close_caches(tc, jc)


def test_decode_from_jax_caches_and_caches_round_trip():
    """JAX's prefill caches carried across (``hybrid_caches_from_numpy``)
    decode as JAX's do; JAX -> port -> JAX is bit for bit."""
    japi, jparams, tapi, tparams, _ = Z.models(ARCH, "xla")
    jf = Z.jitted(japi)
    b = Z.batch(japi.cfg, seed=6)
    jlog, jc = jf.prefill(jparams, Z.jb(b), Z.S + 3)
    want = _np_caches(jc)
    tc = convert.hybrid_caches_from_numpy(tapi.cfg, want["ssm"], want["kv"], device="cpu")
    back = convert.hybrid_caches_to_numpy(tc)
    for part in want:
        for f in want[part]:
            np.testing.assert_array_equal(back[part][f], want[part][f])
    nxt = np.array(jnp.argmax(jlog[:, :, : japi.cfg.vocab_size], -1), np.int32)
    jlog2, _ = jf.decode_step(jparams, jc, jnp.asarray(nxt))
    tlog2, _ = tapi.decode_step(tparams, tc, torch.from_numpy(nxt).long())
    Z.close(tlog2, jlog2)


def test_init_decode_state_matches_jax_layout():
    japi, _, tapi, _, _ = Z.models(ARCH)
    cfg = japi.cfg
    jc = jH.init_decode_state(cfg, Z.B, 12, 3)
    tc = tapi.init_decode_state(Z.B, 12, 3, device="cpu")
    got, want = convert.hybrid_caches_to_numpy(tc), _np_caches(jc)
    for part in want:
        for f in want[part]:
            np.testing.assert_array_equal(got[part][f], want[part][f])


def test_greedy_tokens_match_jax():
    Z.greedy_tokens_match(ARCH)


def test_teacher_forced_decode_matches_forward():
    """One-token decode (the recurrent SSM update, sdpa over each
    invocation's cache) reproduces the forward (chunked SSD, B4's plain
    version)."""
    _, tcfg = Z.cfgs(ARCH, "pallas")
    tapi = tzoo.build(tcfg)
    params = tapi.init_params(0, device="cpu")
    toks = torch.from_numpy(Z.batch(tcfg, seed=3)["tokens"]).long()
    full = tapi.forward(params, {"tokens": toks})
    caches = tapi.init_decode_state(Z.B, max_len=Z.S + 2, device="cpu")
    outs = []
    for t in range(Z.S):
        logits, caches = tapi.decode_step(params, caches, toks[:, t:t + 1])
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, **Z.TOL)


def test_loss_and_grads_match_jax():
    """The shared block's gradient sums its 2 invocations, as JAX's does."""
    Z.loss_and_grads_match(ARCH)


def test_convert_round_trip_hybrid_tree():
    params = Z.params_round_trip(ARCH, "bfloat16")
    assert len(params["mamba"]) == 4 and set(params["mamba"][0]) == {"ln", "ssm"}
    assert set(params["shared"]) == {"ln1", "attn", "ln2", "mlp"}


def test_serve_main_runs_on_cpu(capsys):
    argv = ["--arch", ARCH, "--preset", "smoke", "--prompts", "2", "--prompt-len", "8",
            "--gen", "3"]
    kernels.reset_launches()
    gen = serve.main(argv, device="cpu")
    assert gen.shape == (2, 4) and ((gen >= 0) & (gen < 512)).all()
    assert "[serve] decoded 3 tokens x 2 seqs" in capsys.readouterr().out
    assert kernels.launches()["ssd_scan"] == 0 == kernels.launches()["flash_attention"]
    np.testing.assert_array_equal(gen, serve.main(argv, device="cpu"))
