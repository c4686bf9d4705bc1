"""Wrapper of B5, the Mamba2 SSD chunked scan over the model layout.

On CUDA tensors it launches one of two hand-written kernels, chosen by dtype
alone (:func:`route`): bfloat16 goes to the tensor-core kernel
(``csrc/ssd_scan_tc.cu``: wgmma fed by TMA), float32 to the CUDA-core
kernel (``csrc/ssd_scan.cu``: full f32, no TF32). Both read x, B and C
through their strides (in the model they are views into the conv output),
so no transposed copy is made; a bfloat16 layout that TMA cannot address is
refused before any launch. The plain version :func:`.ref.ssd_scan_ref` runs
only for CPU tensors. ``ssd_scan.launches`` counts the launches of both
kernels, ``ssd_scan.tensor_core_launches`` those of the tensor-core kernel,
``ssd_scan.recompute_launches`` those made inside a backward pass: an
activation checkpoint's recompute (:mod:`repro_torch.remat`).
Unlike the JAX wrapper it takes an ``init_state`` (the carried state at
chunk 0), so the model's ``ssd_chunked`` has one route on the card.

Gradients: on the card the call is a ``torch.autograd.Function`` whose
forward launches the kernel and saves only its inputs, and whose backward
is :func:`ssd_scan_backward`: it recomputes the plain chunked form
(:func:`.ref.ssd_chunked_ref`, the JAX model's jnp ``ssd_chunked``) on the
saved inputs and returns that form's gradients, the gradient JAX takes (JAX
has no backward kernel either). Saving only the inputs keeps a layer's
[B, nc, H, Q, Q] f32 intermediates out of memory between the forward and
the backward; each layer recomputes its own in the backward.

The launch is the registered op ``torch.ops.repro_torch.ssd_scan``
(:func:`scan`), so one call is counted the same on every device: its CUDA
implementation launches the kernel :func:`route` chose, its CPU
implementation is the plain version, its fake implementation gives the
outputs' shapes on the meta device (the dry run), and its FLOP formula
(:func:`flops`) is nc chunk bodies, JAX's dry-run count. The checks, the
route, the launch counters and the autograd Function stay here, around the
op; a call that needs gradients goes through the Function on every device.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.remat import in_backward

from .. import _common
from . import kernel, ref

_MAX_GRID_Y = 65_535
_FLOATS = (torch.float32, torch.bfloat16)


def _check(x, dt, a, Bm, Cm, chunk, init_state) -> int:
    """Raise on what the kernel does not take; returns the chunk length Q."""
    if x.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: x [B,S,H,P] and Bm, Cm [B,S,G,N] expected, got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if Bm.shape[:2] != (B, S) or dt.shape != (B, S, H) or a.shape != (H,):
        raise ValueError(f"ssd_scan: dt [B,S,H] and a [H] matching x {tuple(x.shape)} "
                         f"and Bm {tuple(Bm.shape)} expected, got dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"ssd_scan: {H} heads are not a multiple of {G} groups")
    if N % 8 or not 8 <= N <= 128:
        raise ValueError(f"ssd_scan: state size {N} is not a multiple of 8 in [8, 128]")
    if P % 8 or not 8 <= P <= 64:
        raise ValueError(f"ssd_scan: head dim {P} is not a multiple of 8 in [8, 64]")
    Q = min(int(chunk), S)
    if not 1 <= Q <= 256 or S % Q:
        raise ValueError(f"ssd_scan: chunk {Q} must be in [1, 256] and divide S = {S}")
    if x.dtype not in _FLOATS or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: float32 or bfloat16 x, Bm, Cm of one dtype expected, "
                        f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: float32 dt and a expected, got {dt.dtype}, {a.dtype}")
    if init_state is not None and (init_state.shape != (B, H, N, P)
                                   or init_state.dtype != torch.float32):
        raise ValueError(f"ssd_scan: init_state float32 [{B}, {H}, {N}, {P}] expected, "
                         f"got {init_state.dtype} {tuple(init_state.shape)}")
    return Q


def route(dtype: torch.dtype, shapes, strides, bases) -> str:
    """Which kernel takes a CUDA call: ``"tensor_core"`` for bfloat16,
    ``"cuda_core"`` for float32. ``shapes`` and ``strides`` (elements) are
    x's, Bm's and Cm's, each with a unit last stride; ``bases`` their data
    pointers. Raises ValueError for a bfloat16 layout whose base or (b, s,
    h|g) strides TMA cannot address; a dim of extent 1 is never stepped, so
    its stride does not count."""
    if dtype == torch.float32:
        return "cuda_core"
    _common.check_tma("ssd_scan", dtype, ("x", "Bm", "Cm"), ("bsh", "bsg", "bsg"), shapes,
                      strides, bases)
    return "tensor_core"


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(), device_types="cpu")
def scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
         Cm: torch.Tensor, init_state: Optional[torch.Tensor], chunk: int,
         which: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The registered op: B5 on inputs as the wrapper checked them, by
    chunks of ``chunk`` tokens. On the CPU the plain version (``which``
    unread)."""
    return ref.ssd_scan_ref(x, dt, a, Bm, Cm, chunk=chunk, init_state=init_state)


@scan.register_kernel("cuda")
def _scan_cuda(x, dt, a, Bm, Cm, init_state, chunk, which):
    """The kernel ``which`` names (:func:`route`), into new outputs."""
    B, S, H, P = x.shape
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, Bm.shape[3], P), dtype=torch.float32, device=x.device)
    if which == "tensor_core":
        kernel.ssd_scan_tc(x, dt, a, Bm, Cm, init_state, y, state, chunk,
                           tuple(_common.tma_strides(t.shape, t.stride()) for t in (x, Bm, Cm)))
    elif which == "cuda_core":
        kernel.ssd_scan(x, dt, a, Bm, Cm, init_state, y, state, chunk)
    else:
        raise ValueError(f"ssd_scan: unknown route {which!r}")
    return y, state


@scan.register_fake
def _scan_fake(x, dt, a, Bm, Cm, init_state, chunk, which):
    B, S, H, P = x.shape
    return x.new_empty((B, S, H, P)), x.new_empty((B, H, Bm.shape[3], P),
                                                  dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def flops(x_shape, dt_shape, a_shape, b_shape, c_shape, init_shape, chunk, *args,
          out_shape=None, **kwargs) -> int:
    """nc = S / Q chunk bodies, each the four products of JAX's dry-run
    body (``launch/dryrun.py``'s ``inner_scan_correction``): C.B scores 2
    Q^2 G N, the intra-chunk output 2 Q^2 H P, the inter-chunk output and
    the state update 2 Q H N P each, per sequence."""
    B, S, H, P = x_shape
    G, N = b_shape[2], b_shape[3]
    Q = chunk
    body = B * (2 * Q * Q * G * N + 2 * Q * Q * H * P + 2 * Q * H * N * P + 2 * Q * H * N * P)
    return (S // Q) * body


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 256,
             init_state: torch.Tensor | None = None):
    """x [B,S,H,P]; dt [B,S,H] f32 (post-softplus); a [H] f32 (< 0); Bm/Cm
    [B,S,G,N] -> (y [B,S,H,P] in x's dtype, final state [B,H,N,P] f32), by
    chunks of Q = min(chunk, S) tokens; head h reads group h // (H // G)."""
    Q = _check(x, dt, a, Bm, Cm, chunk, init_state)
    which = "plain"
    if x.device.type not in ("cpu", "meta"):
        tensors = (x, dt, a, Bm, Cm) + (() if init_state is None else (init_state,))
        _common.check_cuda("ssd_scan", *tensors)
        if x.shape[0] > _MAX_GRID_Y:
            raise ValueError(f"ssd_scan: batch {x.shape[0]} must be at most {_MAX_GRID_Y}")
        x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, Bm, Cm))
        a = a.contiguous()
        if init_state is not None:
            init_state = init_state.contiguous()
        xbc = (x, Bm, Cm)
        which = route(x.dtype, [t.shape for t in xbc], [t.stride() for t in xbc],
                      [t.data_ptr() for t in xbc])
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, a, Bm, Cm, init_state)):
        return _SSDScan.apply(x, dt, a, Bm, Cm, init_state, Q, which)
    return _launch(x, dt, a, Bm, Cm, init_state, Q, which)


def _launch(x, dt, a, Bm, Cm, init_state, Q: int, which: str):
    """The op, counted as a launch unless ``which`` is ``"plain"`` (a CPU or
    meta call)."""
    y, state = scan(x, dt, a, Bm, Cm, init_state, Q, which)
    if which != "plain":
        if which == "tensor_core":
            ssd_scan.tensor_core_launches += 1
        if in_backward():
            ssd_scan.recompute_launches += 1
        ssd_scan.launches += 1
    return y, state


def ssd_scan_backward(x, dt, a, Bm, Cm, init_state, chunk: int, gy, gstate):
    """The gradients of :func:`.ref.ssd_chunked_ref` at (x, dt, a, Bm, Cm,
    init_state) against the output cotangents ``gy`` [B,S,H,P] and
    ``gstate`` [B,H,N,P] (either may be None: no gradient flows from that
    output). Returns one gradient per input, None where the input is None
    or takes no gradient. The backward of B5's CUDA route; a plain function
    the CPU tests call."""
    ins = (x, dt, a, Bm, Cm, init_state)
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(t.is_floating_point())
                  for t in ins]
        y, state = ref.ssd_chunked_ref(*leaves[:5], chunk=chunk, init_state=leaves[5])
        outs, cots = [], []
        for o, g in ((y, gy), (state, gstate)):
            if g is not None:
                outs.append(o)
                cots.append(g)
        want = [i for i, t in enumerate(leaves) if t is not None and t.requires_grad]
        got = (torch.autograd.grad(outs, [leaves[i] for i in want], cots, allow_unused=True)
               if outs else [None] * len(want))
    grads = [None] * len(ins)
    for i, g in zip(want, got):
        grads[i] = g
    return tuple(grads)


class _SSDScan(torch.autograd.Function):
    """B5 with the plain chunked form's gradient (module docstring)."""

    @staticmethod
    def forward(ctx, x, dt, a, Bm, Cm, init_state, Q, which):
        ctx.set_materialize_grads(False)   # an unused output's cotangent stays None
        y, state = _launch(x, dt, a, Bm, Cm, init_state, Q, which)
        ctx.save_for_backward(x, dt, a, Bm, Cm, init_state)
        ctx.Q = Q
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        grads = ssd_scan_backward(*ctx.saved_tensors, ctx.Q, gy, gstate)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad[:6])) + (None, None)


ssd_scan.launches = 0
ssd_scan.tensor_core_launches = 0
ssd_scan.recompute_launches = 0
