"""The port's B4 wrapper (``repro_torch.kernels.flash_attention.ops``) on the
CPU, where it runs its plain version, against the JAX package's flash
attention (the Pallas kernel in interpret mode, as ``tests/test_kernels.py``
runs it) and its ``attention_ref`` oracle, on the same numpy inputs.

Tolerances are ``tests/test_kernels.py``'s: 2e-5 in float32, 2e-2 in
bfloat16 (the plain version rounds the probabilities to bfloat16 before the
product with v, as ``attention_ref`` does; the Pallas kernel keeps f32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops, ref

_DT = {"float32": (jnp.float32, torch.float32, 2e-5),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, S, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal(shape, dtype=np.float32)
           for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    jdt, tdt, _ = _DT[dtype]
    return ([jnp.asarray(a, jdt) for a in qkv],
            [torch.from_numpy(a).to(tdt) for a in qkv])


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,dtype", [
    # tests/test_kernels.py's cases
    (2, 128, 4, 2, 32, True, 0, "float32"),
    (1, 256, 4, 1, 16, True, 0, "float32"),      # MQA
    (2, 128, 4, 4, 64, False, 0, "float32"),     # MHA, bidirectional
    (1, 256, 2, 2, 32, True, 64, "float32"),     # sliding window
    (1, 128, 8, 2, 32, True, 0, "bfloat16"),     # bf16
    (2, 384, 6, 2, 32, True, 96, "bfloat16"),    # swa + gqa + bf16
    # the served model's head (stablelm_12b) and command-r's smoke head
    (1, 128, 4, 2, 160, True, 0, "float32"),
    (1, 128, 8, 2, 160, True, 0, "bfloat16"),
    (2, 64, 8, 2, 8, True, 0, "float32"),
])
def test_port_flash_attention_matches_jax(B, S, H, KV, hd, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, S, H, KV, hd, dtype, seed=S + hd)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    tol = _DT[dtype][2]
    want_kernel = fa_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                         block_q=64, block_k=64)
    want_ref = fa_ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want_kernel, np.float32), atol=tol)
    np.testing.assert_allclose(got, np.asarray(want_ref, np.float32), atol=tol)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    _, (q, k, v) = _inputs(1, 32, 4, 2, 16, "float32", seed=0)
    kernels.reset_launches()
    got = ops.flash_attention(q, k, v, causal=True, window=8)
    assert torch.equal(got, ref.attention_ref(q, k, v, causal=True, window=8))
    assert ops.flash_attention.launches == 0
    assert kernels.launches()["flash_attention"] == 0


@pytest.mark.parametrize("hd", [4, 12, 260, 264])
def test_unsupported_head_dim_raises(hd):
    q = torch.zeros(1, 8, 2, hd)
    k = torch.zeros(1, 8, 1, hd)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, k)


def test_bad_group_and_dtype_raise():
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 2, 16),
                            torch.zeros(1, 8, 2, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        x = torch.zeros(1, 8, 2, 16, dtype=torch.float16)
        ops.flash_attention(x, x, x)
