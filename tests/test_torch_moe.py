"""The port's MoE family (``configs.granite_moe_3b`` / ``mixtral_8x22b``,
``models.moe``, MoE blocks in ``models.transformer``, ``convert``'s MoE
trees) against the JAX package on the CPU.

The routing (top-k of an f32 softmax, the stable sort of the flat expert
ids, the segment starts by a scatter-min, ``pos_in_e < C``) is held bit for
bit: ``eidx``, ``order``, ``dest`` and ``keep`` equal JAX's, also under a
capacity factor that drops assignments. The combine is held against JAX's
``.at[token].add`` on the same expert outputs and gates. The models
(smoke configs, f32, both ``attention_impl`` values) at 1e-4 on logits and
caches (``_torch_zoo_common``), teacher-forced decode against the forward
at a capacity that drops nothing (a forward over B*S tokens and a decode
step over B tokens drop differently otherwise).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jM
from repro_torch.models import moe as tM
from repro_torch.models import zoo as tzoo

import _torch_zoo_common as Z

ARCHS = ["granite_moe_3b", "mixtral_8x22b"]
IMPLS = ["xla", "pallas"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the parallel workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_route(cfg, p, xf):
    """JAX's routing lines of ``repro.models.moe._moe_group`` (which returns
    only the combined output), on one group xf [N, D]."""
    N = xf.shape[0]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = jM.capacity(cfg, N)
    logits = jnp.einsum("nd,de->ne", xf, p["router"]).astype(jnp.float32)
    gates, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    idx = jnp.arange(N * K, dtype=jnp.int32)
    seg_start = jnp.full((E,), N * K, jnp.int32).at[se].min(idx, mode="drop")
    pos_in_e = idx - seg_start[se]
    keep = pos_in_e < C
    dest = jnp.where(keep, se * C + pos_in_e, E * C)
    return gates, eidx, order, dest, keep


def _layer(arch, seed=0, **kw):
    jcfg, tcfg = Z.cfgs(arch, **kw)
    jp = jM.moe_params(jcfg, jax.random.key(seed))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal((Z.B, Z.S, jcfg.d_model), dtype=np.float32)
    return jcfg, tcfg, jp, tp, x


# capacity factor 0.25 drops about half the assignments of the smoke configs
@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_equals_jax_bit_for_bit(arch, cf):
    jcfg, tcfg, jp, tp, x = _layer(arch, moe_capacity_factor=cf)
    xf = x.reshape(Z.B * Z.S, -1)
    r = tM.route(tcfg, tp, torch.from_numpy(xf)[None])
    jr = jax.jit(lambda p, x: _jax_route(jcfg, p, x))(jp, jnp.asarray(xf))
    gates, eidx, order, dest, keep = (np.asarray(a) for a in jr)
    np.testing.assert_array_equal(r.eidx[0].numpy(), eidx)
    np.testing.assert_array_equal(r.order[0].numpy(), order)
    np.testing.assert_array_equal(r.dest[0].numpy(), dest)
    np.testing.assert_array_equal(r.keep[0].numpy(), keep)
    np.testing.assert_allclose(r.gates[0].numpy(), gates, atol=1e-6, rtol=1e-6)
    assert keep.all() == (cf == 1.25) and keep.any()


def test_topk_ties_break_to_the_lower_expert_as_in_jax():
    """Equal gates (router logits that tie): the port's routing picks the
    experts ``lax.top_k`` picks, the lower index first, on rows of 2-, 3-
    and 4-way ties; ``torch.topk`` alone does not (ROADMAP C.15)."""
    jcfg, tcfg, jp, tp, _ = _layer("mixtral_8x22b", num_experts_per_tok=2)
    E = jcfg.num_experts
    logits = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                       [0.4, 0.1, 0.4, 0.1], [0.2, 0.2, 0.4, 0.2]], np.float32)
    # x @ router == logits: an identity router on the first E features
    router = np.zeros((jcfg.d_model, E), np.float32)
    router[np.arange(E), np.arange(E)] = 1.0
    x = np.zeros((4, jcfg.d_model), np.float32)
    x[:, :E] = logits
    tp["router"], jp["router"] = torch.from_numpy(router), jnp.asarray(router)
    for k in (1, 2, 3):
        jc, tc = (dataclasses.replace(c, num_experts_per_tok=k) for c in (jcfg, tcfg))
        r = tM.route(tc, tp, torch.from_numpy(x)[None])
        want = np.asarray(_jax_route(jc, jp, jnp.asarray(x))[1])
        np.testing.assert_array_equal(r.eidx[0].numpy(), want)
        assert (want[:, 0] == [1, 0, 0, 2]).all()
    _, te = torch.topk(torch.softmax(torch.from_numpy(logits), -1), 1, dim=-1)
    assert not (te[:, 0].numpy() == [1, 0, 0, 2]).all()


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_combine_equals_jax_scatter_add(cf):
    """The port's ordered gather-sum against JAX's ``.at[token].add`` on
    the same expert outputs, gates and routing: equal bit for bit."""
    jcfg, tcfg, jp, tp, x = _layer("granite_moe_3b", seed=1, moe_capacity_factor=cf)
    N, K = Z.B * Z.S, jcfg.num_experts_per_tok
    xf = jnp.asarray(x.reshape(N, -1))
    gates, eidx, order, dest, keep = _jax_route(jcfg, jp, xf)
    C = jM.capacity(jcfg, N)
    ye = np.random.default_rng(2).standard_normal(
        (jcfg.num_experts * C, jcfg.d_model)).astype(np.float32)
    flat_tok = jnp.repeat(jnp.arange(N, dtype=jnp.int32), K)
    src = jnp.where(keep, dest, 0)
    contrib = jnp.asarray(ye)[src] * jnp.where(keep, gates.reshape(-1)[order], 0.0)[:, None]
    want = jnp.zeros((N, jcfg.d_model)).at[flat_tok[order]].add(contrib)
    t = lambda a: torch.from_numpy(np.array(a))[None]  # noqa: E731
    r = tM.Route(gates=t(gates), eidx=t(eidx).long(), order=t(order).long(),
                 dest=t(dest).long(), keep=t(keep))
    got = tM.combine(r, torch.from_numpy(ye)[None], N)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,cf,groups", [
    ("granite_moe_3b", 1.25, 1), ("granite_moe_3b", 0.25, 2),
    ("mixtral_8x22b", 0.25, 1), ("mixtral_8x22b", 1.25, 2)])
def test_apply_moe_equals_jax(arch, cf, groups):
    jcfg, tcfg, jp, tp, x = _layer(arch, seed=3, moe_capacity_factor=cf, moe_groups=groups)
    got = tM.apply_moe(tcfg, tp, torch.from_numpy(x))
    want = jax.jit(lambda p, x: jM.apply_moe(jcfg, p, x))(jp, jnp.asarray(x))
    Z.close(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, impl):
    japi, jparams, tapi, tparams, _ = Z.models(arch, impl)
    assert "moe" in tparams["blocks"][0] and "mlp" not in tparams["blocks"][0]
    b = Z.batch(japi.cfg)
    got = tapi.forward(tparams, Z.tb(b))
    assert got.shape == (Z.B, Z.S, japi.cfg.padded_vocab)
    Z.close(got, Z.jitted(japi).forward(jparams, Z.jb(b)))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch, impl):
    """Prefill logits and caches, then 4 greedy decode steps' logits and
    caches (mixtral's window 16 < 16 + 4: its ring wraps)."""
    japi, jparams, tapi, tparams, _ = Z.models(arch, impl)
    b = Z.batch(japi.cfg, seed=5)
    max_len = Z.S + Z.GEN + 1
    jf = Z.jitted(japi)
    jlog, jc = jf.prefill(jparams, Z.jb(b), max_len)
    tlog, tc = tapi.prefill(tparams, Z.tb(b), max_len)
    Z.close(tlog, jlog)
    Z.close_kv(tc, jc, Z.S)
    for _ in range(Z.GEN):
        nxt = np.array(jnp.argmax(jlog[:, :, : japi.cfg.vocab_size], -1), np.int32)
        jlog, jc = jf.decode_step(jparams, jc, jnp.asarray(nxt))
        tlog, tc = tapi.decode_step(tparams, tc, torch.from_numpy(nxt).long())
        Z.close(tlog, jlog)
    Z.close_kv(tc, jc, Z.S + Z.GEN)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(arch):
    Z.greedy_tokens_match(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_forward(arch):
    """With C >= every token (capacity factor E / K), the forward drops
    nothing and one-token decode over the cache reproduces its logits."""
    _, tcfg = Z.cfgs(arch, "pallas")
    tcfg = dataclasses.replace(
        tcfg, moe_capacity_factor=tcfg.num_experts / tcfg.num_experts_per_tok)
    tapi = tzoo.build(tcfg)
    params = tapi.init_params(0, device="cpu")
    toks = torch.from_numpy(Z.batch(tcfg, seq=8, seed=3)["tokens"]).long()
    full = tapi.forward(params, {"tokens": toks})
    caches = tapi.init_decode_state(Z.B, max_len=12, device="cpu")
    outs = []
    for t in range(8):
        logits, caches = tapi.decode_step(params, caches, toks[:, t:t + 1])
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, **Z.TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    Z.loss_and_grads_match(arch)


def test_convert_round_trip_moe_tree():
    params = Z.params_round_trip("mixtral_8x22b", "bfloat16")
    moe = params["blocks"][1]["moe"]
    assert tuple(moe["wg"].shape) == (4, 64, 128) and tuple(moe["router"].shape) == (64, 4)
    assert set(params["blocks"][0]) == {"ln1", "attn", "ln2", "moe"}


def test_second_prefill_equals_the_first_bit_for_bit():
    _, _, tapi, tparams, _ = Z.models("granite_moe_3b", "pallas")
    b = Z.tb(Z.batch(tapi.cfg))
    a1, c1 = tapi.prefill(tparams, b, 24)
    a2, c2 = tapi.prefill(tparams, b, 24)
    assert torch.equal(a1, a2) and all(torch.equal(x.k, y.k) for x, y in zip(c1, c2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [1.25, 0.7])
def test_dispatch_rows_equal_a_plain_gather_bit_for_bit(dtype, cf, monkeypatch):
    """The dispatch's ordered backward (``moe._DispatchRows``, ROADMAP
    C.20) against ``torch.gather``, whose backward is a scatter-add over
    repeated token indices: the layer's output and its gradients to x and
    every param equal on the CPU bit for bit, bf16 included (the CPU's
    scatter-add sums bf16 through an f32 accumulator, as the ordered
    backward does), with and without capacity drops."""
    cfg = dataclasses.replace(tzoo.build(Z.cfgs("granite_moe_3b")[1]).cfg, num_experts=8,
                              num_experts_per_tok=3, moe_capacity_factor=cf)
    g = torch.Generator().manual_seed(3)
    p = tM.moe_params(cfg, g)
    x = torch.randn(2, 24, cfg.d_model, generator=g).to(dtype)
    w = torch.randn(2, 24, cfg.d_model, generator=g).to(dtype)

    def grads():
        live = [x.clone().requires_grad_(True)] + [v.clone().requires_grad_(True)
                                                   for v in p.values()]
        y = tM.apply_moe(cfg, dict(zip(p, live[1:])), live[0])
        return (y.detach(),) + torch.autograd.grad((y * w).sum(), live)

    got = grads()
    monkeypatch.setattr(tM._DispatchRows, "apply", lambda xf, tok, pos: torch.gather(
        xf, 1, tok[..., None].expand(*tok.shape, xf.shape[-1])))
    want = grads()
    assert len(got) == len(want) == 6
    assert all(torch.equal(a, b) for a, b in zip(got, want))
