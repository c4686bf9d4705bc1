"""B5, the SSD chunked scan, on the CPU: the port's ``ops.ssd_scan`` (its
plain version ``ref.ssd_scan_ref`` on CPU tensors), ``ref.ssd_ref`` and the
model's ``ssm.ssd_chunked`` against the JAX package's interpret-mode Pallas
kernel, its ``ssd_ref`` and its jnp ``ssd_chunked``.

Inputs are numpy draws fed to both packages; a is distinct per head, and
the G = 2 cases have rep > 1, so a wrong head -> A or head -> group map
shows. Tolerances: ``tests/test_kernels.py``'s, 1e-3 in f32 and 5e-2 in
bf16 (absolute and relative) for a chunked form against the recurrence or
the kernel, 2e-3 for the model's path against the kernel; 1e-5 in f32
between twins that take the same steps (f32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan import ref as jref
from repro.models import ssm as jS
from repro_torch import kernels
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models import ssm as tS

_DT = {"float32": (jnp.float32, torch.float32, 1e-3),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _draw(B, S, H, G, N, P, seed):
    """tests/test_kernels.py's statistics from numpy: normal x, B and C / 2,
    dt = softplus(normal) / 2, a = -exp(normal * 0.3) distinct per head."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = (np.logaddexp(rng.standard_normal((B, S, H)), 0.0) * 0.5).astype(np.float32)
    a = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    return x, dt, a, Bm, Cm


def _both(arrs, dtype):
    """(jax arrays, torch tensors): x, Bm, Cm in ``dtype``, dt and a f32."""
    jdt, tdt, _ = _DT[dtype]
    x, dt, a, Bm, Cm = arrs
    j = [jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(Bm, jdt),
         jnp.asarray(Cm, jdt)]
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(a),
         torch.from_numpy(Bm).to(tdt), torch.from_numpy(Cm).to(tdt)]
    return j, t


def _jax_recurrence(x, dt, a, Bm, Cm):
    """JAX's ssd_ref laid out as tests/test_kernels.py lays it out."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = jnp.repeat(Bm, rep, axis=2).transpose(0, 2, 1, 3).reshape(B * H, S, N)
    Ch = jnp.repeat(Cm, rep, axis=2).transpose(0, 2, 1, 3).reshape(B * H, S, N)
    y, st = jref.ssd_ref(x.transpose(0, 2, 1, 3).reshape(B * H, S, P),
                         dt.transpose(0, 2, 1).reshape(B * H, S), jnp.tile(a, B), Bh, Ch)
    return y.reshape(B, H, S, P).transpose(0, 2, 1, 3), st.reshape(B, H, N, P)


def _close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = want.float()
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


CASES = [
    # tests/test_kernels.py's test_ssd_scan_matches_recurrence cases
    (2, 64, 4, 1, 16, 16, 16, "float32"),
    (1, 128, 4, 2, 32, 16, 32, "float32"),    # 2 groups
    (2, 64, 2, 2, 16, 32, 64, "float32"),     # chunk == S
    (1, 64, 4, 1, 16, 16, 16, "bfloat16"),
    # G = 2 with rep = 2, a distinct A per head; and in bf16
    (2, 96, 4, 2, 16, 16, 32, "float32"),
    (1, 64, 4, 2, 16, 16, 16, "bfloat16"),
]


@pytest.mark.parametrize("B,S,H,G,N,P,chunk,dtype", CASES)
def test_ssd_scan_matches_jax_kernel_and_recurrence(B, S, H, G, N, P, chunk, dtype):
    (jx, jdt, ja, jB, jC), (tx, tdt, ta, tB, tC) = _both(_draw(B, S, H, G, N, P, S + N),
                                                         dtype)
    y, st = ops.ssd_scan(tx, tdt, ta, tB, tC, chunk=chunk)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    assert st.dtype == torch.float32 and st.shape == (B, H, N, P)
    tol = _DT[dtype][2]
    jy, jst = jops.ssd_scan(jx, jdt, ja, jB, jC, chunk=chunk)
    for want_y, want_st in ((jy, jst), _jax_recurrence(jx, jdt, ja, jB, jC),
                            ref.ssd_ref_model_layout(tx, tdt, ta, tB, tC)):
        _close(y, want_y, tol)
        _close(st, want_st, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_carries_init_state(dtype):
    """The second half from the first half's state equals the whole
    sequence through JAX's kernel and through the recurrence."""
    (jx, jdt, ja, jB, jC), (tx, tdt, ta, tB, tC) = _both(_draw(2, 128, 4, 2, 16, 16, 5),
                                                         dtype)
    _, mid = ops.ssd_scan(tx[:, :64], tdt[:, :64], ta, tB[:, :64], tC[:, :64], chunk=32)
    assert float(mid.abs().max()) > 0.1
    y2, st = ops.ssd_scan(tx[:, 64:], tdt[:, 64:], ta, tB[:, 64:], tC[:, 64:], chunk=32,
                          init_state=mid)
    tol = _DT[dtype][2]
    jy, jst = jops.ssd_scan(jx, jdt, ja, jB, jC, chunk=32)
    ry, rst = _jax_recurrence(jx, jdt, ja, jB, jC)
    for want_y, want_st in ((jy, jst), (ry, rst)):
        _close(y2, np.asarray(want_y, np.float32)[:, 64:], tol)
        _close(st, want_st, tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_ref_matches_jax_ssd_ref(seed):
    rng = np.random.default_rng(seed)
    BH, S, N, P = 6, 40, 16, 8
    x = rng.standard_normal((BH, S, P), dtype=np.float32)
    dt = (np.logaddexp(rng.standard_normal((BH, S)), 0.0) * 0.5).astype(np.float32)
    a = (-np.exp(rng.standard_normal(BH) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((BH, S, N), dtype=np.float32)
    Cm = rng.standard_normal((BH, S, N), dtype=np.float32)
    y, st = ref.ssd_ref(*map(torch.from_numpy, (x, dt, a, Bm, Cm)))
    jy, jst = jref.ssd_ref(*map(jnp.asarray, (x, dt, a, Bm, Cm)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5, rtol=1e-5)


def _cfgs(G, chunk):
    kw = dict(name="t", family="ssm", num_layers=1, d_model=32, ssm_state=16,
              ssm_head_dim=16, ssm_groups=G, ssm_chunk=chunk)
    return JModelConfig(**kw), TModelConfig(**kw)


@pytest.mark.parametrize("G,chunk,dtype,init", [
    (1, 16, "float32", False),    # tests/test_kernels.py's model-path case
    (2, 16, "float32", False),
    (1, 32, "float32", True),
    (1, 16, "bfloat16", False),
    (2, 64, "bfloat16", True),
])
def test_model_ssd_chunked_matches_jax_and_the_kernel(G, chunk, dtype, init):
    jcfg, tcfg = _cfgs(G, chunk)
    H, P, N = tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state
    arrs = _draw(2, 64, H, G, N, P, 3 + G)
    (jx, jdt, ja, jB, jC), (tx, tdt, ta, tB, tC) = _both(arrs, dtype)
    s0 = (np.random.default_rng(4).standard_normal((2, H, N, P)).astype(np.float32)
          if init else None)
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    y, st = tS.ssd_chunked(tcfg, tx, tdt, ta, tB, tC, init_state=ts0)
    jy, jst = jS.ssd_chunked(jcfg, jx, jdt, ja, jB, jC, init_state=js0)
    assert y.dtype == tx.dtype
    twin = 1e-5 if dtype == "float32" else 5e-2
    _close(y, jy, twin)
    _close(st, jst, twin)
    if dtype == "float32":   # the twin of test_ssd_model_path_matches_kernel
        ky, kst = ops.ssd_scan(tx, tdt, ta, tB, tC, chunk=chunk, init_state=ts0)
        torch.testing.assert_close(y, ky, atol=2e-3, rtol=2e-3)
        torch.testing.assert_close(st, kst, atol=2e-3, rtol=2e-3)


def test_model_ssd_chunked_refuses_a_chunk_that_does_not_divide_s():
    _, tcfg = _cfgs(1, 16)
    _, (tx, tdt, ta, tB, tC) = _both(_draw(1, 40, 4, 1, 16, 16, 0), "float32")
    with pytest.raises(ValueError, match="does not divide"):
        tS.ssd_chunked(tcfg, tx, tdt, ta, tB, tC)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    _, (tx, tdt, ta, tB, tC) = _both(_draw(1, 32, 4, 2, 8, 8, 1), "float32")
    kernels.reset_launches()
    y, st = ops.ssd_scan(tx, tdt, ta, tB, tC, chunk=16)
    want_y, want_st = ref.ssd_scan_ref(tx, tdt, ta, tB, tC, chunk=16)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    assert ops.ssd_scan.launches == 0
    assert kernels.launches()["ssd_scan"] == 0


def _zeros(S=32, H=4, G=1, N=16, P=16, dtype=torch.float32):
    return (torch.zeros(1, S, H, P, dtype=dtype), torch.zeros(1, S, H),
            torch.zeros(H), torch.zeros(1, S, G, N, dtype=dtype),
            torch.zeros(1, S, G, N, dtype=dtype))


@pytest.mark.parametrize("kw,chunk,match", [
    (dict(N=12), 16, "state size"),
    (dict(N=136), 16, "state size"),
    (dict(P=4), 16, "head dim"),
    (dict(P=72), 16, "head dim"),
    (dict(S=512), 512, "chunk"),
    (dict(S=40), 16, "chunk"),
    (dict(H=3, G=2), 16, "multiple"),
])
def test_unsupported_shapes_raise(kw, chunk, match):
    with pytest.raises(ValueError, match=match):
        ops.ssd_scan(*_zeros(**kw), chunk=chunk)


def test_bad_dtypes_raise():
    x, dt, a, Bm, Cm = _zeros(dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.ssd_scan(x, dt, a, Bm, Cm)
    x, dt, a, Bm, Cm = _zeros()
    with pytest.raises(TypeError, match="one dtype"):
        ops.ssd_scan(x.bfloat16(), dt, a, Bm, Cm)
    with pytest.raises(TypeError, match="float32 dt and a"):
        ops.ssd_scan(x, dt.double(), a, Bm, Cm)
    with pytest.raises(ValueError, match="init_state"):
        ops.ssd_scan(x, dt, a, Bm, Cm, init_state=torch.zeros(1, 4, 16, 8))


# ---------------------------------------------------------------------------
# The route on CUDA tensors: a pure function of dtype, shapes, strides and
# base addresses, tested here without a card
# ---------------------------------------------------------------------------
def _layout(*ts, bases=None):
    return ([t.shape for t in ts], [t.stride() for t in ts],
            bases if bases is not None else [0] * len(ts))


def _conv_views(B, S, H, G, N, P, extra=0, dtype=torch.bfloat16):
    """x, Bm and Cm as the model's conv output holds them: views of one
    [B, S, H*P + 2*G*N (+ extra)] buffer; their bases in bytes from its own."""
    buf = torch.empty(B, S, H * P + 2 * G * N + extra, dtype=dtype)
    x = buf[..., :H * P].reshape(B, S, H, P)
    Bm = buf[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = buf[..., H * P + G * N:H * P + 2 * G * N].reshape(B, S, G, N)
    e = buf.element_size()
    return (x, Bm, Cm), [0, H * P * e, (H * P + G * N) * e]


# the admitted range's ends and the kernel's instantiation boundaries: N in
# one or two 64-column boxes, P padded to 32 or 64 columns
@pytest.mark.parametrize("N,P", [(n, p) for n in (8, 64, 72, 128) for p in (8, 32, 40, 64)])
def test_route_is_chosen_by_dtype_for_every_admitted_width(N, P):
    x = torch.empty(2, 64, 4, P)
    Bm = torch.empty(2, 64, 2, N)
    assert ops.route(torch.bfloat16, *_layout(x, Bm, Bm)) == "tensor_core"
    assert ops.route(torch.float32, *_layout(x, Bm, Bm)) == "cuda_core"


@pytest.mark.parametrize("H,G,N,P,extra", [(32, 1, 128, 64, 0),   # mamba2_370m's conv output
                                           (8, 2, 32, 16, 8),
                                           (4, 4, 8, 8, 0)])
def test_route_takes_views_of_the_conv_output(H, G, N, P, extra):
    """The served layout: x, B and C sliced from one [B, S, H*P + 2*G*N]
    buffer, B and C starting H*P and H*P + G*N elements in."""
    xbc, bases = _conv_views(2, 64, H, G, N, P, extra)
    assert not xbc[0].is_contiguous() and xbc[1].stride(1) == H * P + 2 * G * N + extra
    assert ops.route(torch.bfloat16, *_layout(*xbc, bases=bases)) == "tensor_core"


@pytest.mark.parametrize("case,match", [
    ("base", "boundary"),          # B starts 8 bytes past a 16-byte boundary
    ("h_stride", "h stride"),      # x rows of 20 elements: 40 bytes
    ("s_stride", "s stride"),      # C with an s stride of 12 elements: 24 bytes
    ("broadcast", "b stride"),     # a zero stride on a batch of 2
])
def test_route_refuses_bf16_layouts_tma_cannot_address(case, match):
    x = torch.empty(2, 16, 4, 16)
    Bm = torch.empty(2, 16, 1, 16)
    shapes, strides, bases = _layout(x, Bm, Bm)
    if case == "base":
        bases = [0, 8, 0]
    elif case == "h_stride":
        strides[0] = (16 * 4 * 20, 4 * 20, 20, 1)
    elif case == "s_stride":
        shapes[2], strides[2] = (2, 16, 1, 8), (16 * 12, 12, 12, 1)
    else:
        strides[2] = (0, 16, 16, 1)
    with pytest.raises(ValueError, match=match):
        ops.route(torch.bfloat16, shapes, strides, bases)
    # f32 never goes to the tensor maps, so it is never refused for its layout
    assert ops.route(torch.float32, shapes, strides, bases) == "cuda_core"


def test_route_ignores_the_stride_of_an_extent_one_dim():
    """One group (the served G = 1): the g stride, whatever it is, does not
    refuse the call, and the tensor map gets the contiguous one."""
    x = torch.empty(2, 16, 4, 16)
    shape, odd = (2, 16, 1, 24), (16 * 40, 40, 3, 1)
    shapes, strides, bases = _layout(x, x, x)
    shapes[1:], strides[1:] = [shape] * 2, [odd] * 2
    assert ops.route(torch.bfloat16, shapes, strides, bases) == "tensor_core"
    from repro_torch.kernels import _common
    assert _common.tma_strides(shape, odd) == (16 * 40, 40, 24)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_core_kernel_takes_float32_only(dtype):
    """The CUDA-core kernel has no bfloat16 instantiation (bf16 is the
    tensor-core kernel's): any other dtype is refused before the library is
    loaded or a kernel launched."""
    from repro_torch.kernels.ssd_scan import kernel

    x, dt, a, Bm, Cm = _zeros(dtype=dtype)
    y = torch.empty_like(x)
    state = torch.empty(1, 4, 16, 16)
    with pytest.raises(TypeError, match="float32"):
        kernel.ssd_scan(x, dt, a, Bm, Cm, None, y, state, 16)


def test_reset_launches_clears_the_tensor_core_count():
    ops.ssd_scan.tensor_core_launches = 3
    kernels.reset_launches()
    assert ops.ssd_scan.tensor_core_launches == 0
