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


# ---------------------------------------------------------------------------
# The route on CUDA tensors: a pure function of dtype, shapes, strides and
# base addresses, tested here without a card
# ---------------------------------------------------------------------------
def _layout(*xs, bases=None):
    return ([x.shape for x in xs], [x.stride() for x in xs],
            bases if bases is not None else [0] * len(xs))


@pytest.mark.parametrize("hd", range(8, 257, 8))
def test_route_is_chosen_by_dtype_for_every_admitted_head_dim(hd):
    q, k = torch.empty(2, 77, 8, hd), torch.empty(2, 77, 2, hd)
    assert ops.route(torch.bfloat16, *_layout(q, k, k)) == "tensor_core"
    assert ops.route(torch.float32, *_layout(q, k, k)) == "cuda_core"


@pytest.mark.parametrize("H,KV,hd", [(32, 8, 160), (8, 1, 128), (4, 4, 8)])
def test_route_takes_views_of_a_fused_projection(H, KV, hd):
    """The served layout: q, k, v sliced from one [B, S, (H + 2 KV) hd]
    projection, k and v starting (H or H + KV) * hd elements in."""
    qkv = torch.empty(2, 64, (H + 2 * KV) * hd, dtype=torch.bfloat16)
    q = qkv[..., :H * hd].reshape(2, 64, H, hd)
    k = qkv[..., H * hd:(H + KV) * hd].reshape(2, 64, KV, hd)
    v = qkv[..., (H + KV) * hd:].reshape(2, 64, KV, hd)
    bases = [0, 2 * H * hd, 2 * (H + KV) * hd]
    assert ops.route(torch.bfloat16, *_layout(q, k, v, bases=bases)) == "tensor_core"


@pytest.mark.parametrize("case,match", [
    ("base", "boundary"),          # k starts 8 bytes past a 16-byte boundary
    ("h_stride", "h stride"),      # rows of 20 elements: 40 bytes
    ("s_stride", "s stride"),      # an s stride of 12 elements: 24 bytes
    ("broadcast", "b stride"),     # a zero stride on a batch of 2
])
def test_route_refuses_bf16_layouts_tma_cannot_address(case, match):
    q = torch.empty(2, 16, 4, 16)
    k = torch.empty(2, 16, 2, 16)
    shapes, strides, bases = _layout(q, k, k)
    if case == "base":
        bases = [0, 8, 0]
    elif case == "h_stride":
        strides[1] = (16 * 2 * 20, 2 * 20, 20, 1)
    elif case == "s_stride":
        shapes[1], strides[1] = (2, 16, 1, 8), (16 * 12, 12, 12, 1)
    else:
        strides[2] = (0, 32, 16, 1)
    with pytest.raises(ValueError, match=match):
        ops.route(torch.bfloat16, shapes, strides, bases)
    # f32 never goes to the tensor maps, so it is never refused for its layout
    assert ops.route(torch.float32, shapes, strides, bases) == "cuda_core"


def test_route_ignores_the_stride_of_an_extent_one_dim():
    """A dim of extent 1 is never stepped: its stride, whatever it is, does
    not refuse the call, and the tensor map gets the contiguous one."""
    shape = (1, 16, 1, 24)
    odd = (5, 24, 3, 1)
    assert ops.route(torch.bfloat16, [shape] * 3, [odd] * 3, [0] * 3) == "tensor_core"
    assert ops.tma_strides(shape, odd) == (16 * 24, 24, 24)
    assert ops.tma_strides((2, 16, 4, 24), (3 * 16 * 4 * 24, 4 * 24, 24, 1)) == \
        (3 * 16 * 4 * 24, 4 * 24, 24)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_core_kernel_takes_float32_only(dtype):
    """The CUDA-core kernel has no bfloat16 instantiation (bf16 is the
    tensor-core kernel's): any other dtype is refused before the library is
    loaded or a kernel launched."""
    from repro_torch.kernels.flash_attention import kernel

    q = torch.zeros((1, 16, 2, 16), dtype=dtype)
    with pytest.raises(TypeError, match="float32"):
        kernel.flash_attention(q, q[:, :, :1], q[:, :, :1], torch.empty_like(q), True, 0)
