"""Activation checkpointing (``cfg.remat``, :mod:`repro_torch.remat`) in
every LM family against the port without it and against the JAX package,
on the CPU.

For stablelm (dense), granite_moe (MoE), mamba2, zamba2 (hybrid) and
whisper (encoder-decoder), smoke configs in f32 (``_torch_zoo_common``):
the loss and every gradient with ``remat=True`` are ``torch.equal`` to
``remat=False`` (the recompute runs the same ops on the same inputs), and
both are within ``_torch_zoo_common``'s tolerances of JAX's jitted
``value_and_grad`` under JAX's ``remat=True``. The recompute is seen to
happen: each checkpointed unit runs again in the backward (a counter on
it), the hybrid's Mamba2 layers three times (the group's checkpoint nests
the layers'), and a checkpointed step keeps fewer bytes for its backward
(``torch.autograd.graph.saved_tensors_hooks``). The two checkpoints that
are on whatever ``cfg.remat`` says, ``chunked_sdpa``'s query blocks and the
plain SSD form's chunk bodies, give gradients bit-equal to their loops
unwrapped. No-grad forwards do not checkpoint.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch import convert
from repro_torch import remat as R
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import attention as tA
from repro_torch.models import encdec as tE
from repro_torch.models import hybrid as tH
from repro_torch.models import mamba_lm as tML
from repro_torch.models import transformer as tT

import _torch_zoo_common as Z

ARCHS = ["stablelm_12b", "granite_moe_3b", "mamba2_370m", "zamba2_2p7b", "whisper_large_v3"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the parallel workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_and_grads(arch, remat: bool):
    """The port's loss and gradients (as leaves in JAX's layout) at the
    smoke config with ``remat``, from JAX's perturbed params."""
    _, _, tapi, tparams, _ = Z.models(arch, "xla", remat=remat)
    b = Z.batch(tapi.cfg)
    leaves, spec = pytree.tree_flatten(tparams)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss = tapi.loss(pytree.tree_unflatten(live, spec), Z.tb(b))
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), grads, spec


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_and_matches_jax(arch):
    on, g_on, spec = _loss_and_grads(arch, True)
    off, g_off, _ = _loss_and_grads(arch, False)
    assert torch.equal(on, off)
    assert len(g_on) == len(g_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)
    japi, jparams, _, _, _ = Z.models(arch, "xla", remat=True)
    assert japi.cfg.remat
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(jparams, Z.jb(Z.batch(japi.cfg)))
    np.testing.assert_allclose(float(on), float(jl), rtol=1e-5)
    got = jax.tree_util.tree_leaves(convert.lm_params_to_numpy(
        pytree.tree_unflatten(list(g_on), spec)))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jg))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **Z.TOL)


# (module, the checkpointed unit's name, units a forward: the config's count)
UNITS = {
    "stablelm_12b": (tT, "_block_fwd", lambda c: c.num_layers),
    "granite_moe_3b": (tT, "_block_fwd", lambda c: c.num_layers),
    "mamba2_370m": (tML, "_layer_out", lambda c: c.num_layers),
    "zamba2_2p7b": (tH, "_mamba_out", lambda c: c.num_layers),
    "whisper_large_v3": (tE, "_dec_block_over", lambda c: c.num_layers),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_the_recompute_runs_in_the_backward(arch, monkeypatch):
    """Counted in the forward and in the backward: each unit runs once in
    the forward, and again in the backward under remat (the hybrid's Mamba2
    layers twice: the group's recompute and their own); without remat, or
    without grad, never in a backward."""
    mod, name, units = UNITS[arch]
    calls = {"forward": 0, "backward": 0}
    orig = getattr(mod, name)

    def counting(*args):
        calls["backward" if R.in_backward() else "forward"] += 1
        return orig(*args)

    monkeypatch.setattr(mod, name, counting)
    n = units(Z.models(arch, "xla", remat=True)[2].cfg)
    again = 2 if arch == "zamba2_2p7b" else 1
    for remat, want in ((True, again * n), (False, 0)):
        calls.update(forward=0, backward=0)
        _loss_and_grads(arch, remat)
        assert calls == {"forward": n, "backward": want}, (remat, calls)
    _, _, tapi, tparams, _ = Z.models(arch, "xla", remat=True)
    calls.update(forward=0, backward=0)
    with torch.no_grad():
        tapi.loss(tparams, Z.tb(Z.batch(tapi.cfg)))
    assert calls == {"forward": n, "backward": 0}


@pytest.mark.parametrize("arch", ["stablelm_12b", "zamba2_2p7b"])
def test_remat_keeps_fewer_bytes_for_the_backward(arch):
    """The bytes the autograd graph saves for the backward, over one loss:
    a checkpointed step saves its units' inputs, not their insides."""
    def saved(remat):
        n = [0]

        def pack(t):
            n[0] += t.numel() * t.element_size()
            return t

        _, _, tapi, tparams, _ = Z.models(arch, "xla", remat=remat)
        leaves, spec = pytree.tree_flatten(tparams)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tapi.loss(pytree.tree_unflatten(live, spec), Z.tb(Z.batch(tapi.cfg)))
        return n[0]

    on, off = saved(True), saved(False)
    assert 0 < on < off / 2, (on, off)


def _unwrapped(monkeypatch, module):
    """``module``'s checkpoints replaced by the plain call."""
    monkeypatch.setattr(module, "remat", lambda fn, *args, on=True: fn(*args))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 12)])
def test_chunked_sdpa_query_block_checkpoint_is_bit_equal(causal, window, monkeypatch):
    """``chunked_sdpa`` under grad checkpoints each query block whatever
    ``cfg.remat`` says (JAX's ``lax.map(jax.checkpoint(one_q_block))``):
    output and q / k / v gradients bit-equal to the unwrapped loop."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 32, 4, 8, generator=g)
    k, v = torch.randn(2, 32, 2, 8, generator=g), torch.randn(2, 32, 2, 8, generator=g)
    w = torch.randn(2, 32, 4, 8, generator=g)

    def run():
        live = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tA.chunked_sdpa(None, *live, causal=causal, window=window, block_q=8,
                              block_k=8)
        return (out.detach(),) + torch.autograd.grad((out * w).sum(), live)

    kept = []

    def pack(t):
        kept.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        got = run()
    n_on = sum(kept)
    _unwrapped(monkeypatch, tA)
    kept.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        want = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert n_on < sum(kept)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunk_body_checkpoint_is_bit_equal(init, monkeypatch):
    """The plain SSD chunked form checkpoints each chunk body under grad
    (JAX's ``lax.scan(jax.checkpoint(body))``): y, the final state and
    every gradient bit-equal to the unwrapped loop."""
    g = torch.Generator().manual_seed(1)
    ins = [torch.randn(2, 32, 4, 8, generator=g), torch.rand(2, 32, 4, generator=g) * 0.5,
           -(torch.rand(4, generator=g) + 0.2), torch.randn(2, 32, 2, 8, generator=g),
           torch.randn(2, 32, 2, 8, generator=g)]
    st = torch.randn(2, 4, 8, 8, generator=g) if init else None
    gy, gs = torch.randn(2, 32, 4, 8, generator=g), torch.randn(2, 4, 8, 8, generator=g)

    def run():
        live = [t.clone().requires_grad_(True) for t in ins]
        s0 = None if st is None else st.clone().requires_grad_(True)
        y, fs = ssd_ref.ssd_chunked_ref(*live, chunk=8, init_state=s0)
        loss = (y * gy).sum() + (fs * gs).sum()
        return (y.detach(), fs.detach()) + torch.autograd.grad(
            loss, live + ([] if s0 is None else [s0]))

    got = run()
    _unwrapped(monkeypatch, ssd_ref)
    want = run()
    assert len(got) == len(want) == 7 + init
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_remat_is_the_plain_call_without_grad():
    """:func:`remat` runs ``fn`` again in the backward only under grad mode
    and with ``on``; otherwise it is the call itself. Values and gradients
    are the plain call's either way."""
    x = torch.randn(3, requires_grad=True)
    for on, grad, want in ((True, True, [False, True]), (False, True, [False]),
                           (True, False, [False])):
        calls = []

        def f(t):
            calls.append(R.in_backward())
            return torch.sin(t)

        with torch.set_grad_enabled(grad):
            y = R.remat(f, x, on=on)
        assert torch.equal(y.detach(), torch.sin(x).detach())
        if grad:
            assert torch.equal(torch.autograd.grad(y.sum(), x)[0], torch.cos(x).detach())
        assert calls == want, (on, grad, calls)
    assert not R.in_backward()


def test_config_default_is_jax_remat():
    """``cfg.remat`` defaults to JAX's True in every config of the zoo."""
    from repro import config as jconfig
    from repro_torch import config as tconfig

    for arch in tconfig.ARCH_IDS:
        assert tconfig.get_config(arch).remat == jconfig.get_config(arch).remat is True
        assert tconfig.get_smoke_config(arch).remat is True
