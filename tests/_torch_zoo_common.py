"""Shared helpers of the LM zoo tests that hold the port's moe, hybrid and
encdec families (and the vlm batch) against the JAX package on the CPU.

Each model is a smoke config in float32 with the given ``attention_impl``
(JAX's ``"pallas"`` runs its kernel in interpret mode; the port's runs B4's
plain version on CPU tensors). JAX's ``init_params`` draws the parameters;
seeded numpy noise moves the leaves JAX initializes to constants (norm
scales and biases, Mamba2's ``A_log`` / ``dt_bias`` / ``D`` /
``norm_scale`` / ``conv_b``), which would otherwise hide an indexing
fault; ``convert.lm_params_from_numpy`` carries them across. Batches are
numpy draws fed to both.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro import config as jconfig
from repro.models import zoo as jzoo
from repro.train.steps import make_decode_step as j_make_decode_step
from repro_torch import config as tconfig
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import zoo as tzoo

TOL = dict(atol=1e-4, rtol=1e-4)
B, S, GEN = 2, 16, 4
# the constant-initialized leaves and the scale of the noise put on them
_NOISE = {"A_log": 0.5, "dt_bias": 0.5, "D": 0.3, "norm_scale": 0.2, "conv_b": 0.2,
          "scale": 0.2, "bias": 0.2, "bq": 0.2, "bk": 0.2, "bv": 0.2, "bi": 0.2,
          "bo": 0.2}


def cfgs(arch, impl="xla", **kw):
    over = dict(dict(dtype="float32", attention_impl=impl), **kw)
    return (dataclasses.replace(jconfig.get_smoke_config(arch), **over),
            dataclasses.replace(tconfig.get_smoke_config(arch), **over))


def perturb(tree, seed=0):
    """Seeded noise on the leaves JAX initializes to constants (in place)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k in _NOISE:
                a = np.asarray(v)
                t[k] = (a + rng.standard_normal(a.shape) * _NOISE[k]).astype(a.dtype)
    walk(tree)
    return tree


def models(arch, impl="xla", seed=0, **kw):
    """(JAX api, JAX params, port api, port params, the numpy tree), built
    once per arguments in a test process (the tests only read them), so
    each JAX function of one api compiles once (:func:`jitted`)."""
    return _models(arch, impl, seed, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _models(arch, impl, seed, kw):
    jcfg, tcfg = cfgs(arch, impl, **dict(kw))
    japi, tapi = jzoo.build(jcfg), tzoo.build(tcfg)
    tree = perturb(jax.tree_util.tree_map(np.array, japi.init_params(jax.random.key(seed))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return japi, jparams, tapi, convert.lm_params_from_numpy(tcfg, tree, device="cpu"), tree


def batch(cfg, seq=S, seed=0, rows=B):
    """A numpy batch as ``zoo.make_demo_batch`` shapes it: tokens, plus a
    vlm's ``min(8, seq // 2)`` patch embeddings or audio's frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (rows, seq), dtype=np.int32)}
    frames = {"vlm": min(8, seq // 2), "audio": cfg.encoder_seq}.get(cfg.family)
    if frames is not None:
        if cfg.family == "vlm":
            out["tokens"] = out["tokens"][:, : seq - frames]
        out["frontend_embeds"] = (rng.standard_normal((rows, frames, cfg.d_model))
                                  * 0.5).astype(np.float32)
    return out


class Jitted:
    """JAX's ``forward``, ``prefill`` (``max_len`` static) and
    ``decode_step`` of one ``ModelAPI``, jitted: one compile each, where
    eager JAX would dispatch the model op by op."""

    def __init__(self, japi):
        self.forward = jax.jit(japi.forward)
        self.prefill = jax.jit(japi.prefill, static_argnums=2)
        self.decode_step = jax.jit(japi.decode_step)
        self.greedy_step = jax.jit(j_make_decode_step(japi))


@functools.lru_cache(maxsize=None)
def jitted(japi) -> Jitted:
    return Jitted(japi)


def jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b):
    return {k: torch.from_numpy(np.array(v)).long() if k in ("tokens", "positions")
            else torch.from_numpy(np.array(v)) for k, v in b.items()}


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               **(tol or TOL))


def close_kv(tcaches, jcaches, length):
    """The port's per-layer KVCaches against JAX's stacked KVCache."""
    assert len(tcaches) == jcaches.k.shape[0]
    for i, c in enumerate(tcaches):
        assert c.length == length == int(jcaches.length[i])
        close(c.k, jcaches.k[i])
        close(c.v, jcaches.v[i])


def greedy_tokens_match(arch, impl="pallas", seed=11, seq=S):
    """The port's ``serve_batch`` against JAX's prefill + jitted greedy
    decode steps on the same params and prompts: every token equal."""
    japi, jparams, tapi, tparams, _ = models(arch, impl)
    b = batch(japi.cfg, seq, seed)
    max_len = seq + GEN + 1
    jf = jitted(japi)
    jlog, jc = jf.prefill(jparams, jb(b), max_len)
    jt = jnp.argmax(jlog[:, :, : japi.cfg.vocab_size], -1).astype(jnp.int32)
    jout = [np.asarray(jt)]
    for _ in range(GEN):
        jt, jc = jf.greedy_step(jparams, jc, jt)
        jout.append(np.asarray(jt))
    res = serve.serve_batch(tapi, tparams, tb(b), GEN)
    np.testing.assert_array_equal(res.tokens, np.concatenate(jout, axis=1))


def loss_and_grads_match(arch, **kw):
    """``ModelAPI.loss`` (1e-5 relative) and its gradients (``TOL``, every
    leaf in JAX's layout) against JAX's jitted ``value_and_grad`` (the
    ``tests/test_smoke_archs.py`` protocol's grad step); the gradient is
    non-zero."""
    japi, jparams, tapi, tparams, _ = models(arch, "xla", **kw)
    b = batch(japi.cfg)
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(jparams, jb(b))
    leaves, spec = pytree.tree_flatten(tparams)
    live = [p.detach().requires_grad_(True) for p in leaves]
    tl = tapi.loss(pytree.tree_unflatten(live, spec), tb(b))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, live)
    got = jax.tree_util.tree_leaves(convert.lm_params_to_numpy(
        pytree.tree_unflatten(list(grads), spec)))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jg))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert sum(float(np.square(g).sum()) for g in got) > 0


def params_round_trip(arch, param_dtype="float32"):
    """JAX tree -> port -> JAX tree, bit for bit and in JAX's structure."""
    jcfg, tcfg = cfgs(arch, param_dtype=param_dtype)
    tree = jax.tree_util.tree_map(np.asarray, jzoo.build(jcfg).init_params(jax.random.key(4)))
    params = convert.lm_params_from_numpy(tcfg, tree, device="cpu")
    back = convert.lm_params_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b_ in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b_, np.float32))
    again = convert.lm_params_from_numpy(tcfg, back, device="cpu")
    for a, b_ in zip(pytree.tree_leaves(again), pytree.tree_leaves(params)):
        assert a.dtype == getattr(torch, param_dtype) and torch.equal(a, b_)
    return params
