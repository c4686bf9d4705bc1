"""Dry run of the assignment's (arch x shape) grid on the meta device: each
cell's train step (forward, backward and AdamW), prefill or decode step is
built at full width with every tensor on ``device="meta"`` and run once
under ``torch.utils.flop_counter.FlopCounterMode``, inside one dispatch
mode (:class:`Traffic`) that keeps the peak of the live storage bytes and
sums the bytes each op reads and writes. The port of the JAX package's
``launch/dryrun.py``, against the H100's spec-sheet constants
(:mod:`repro_torch.launch.hw`).

    python -m repro_torch.launch.dryrun --all --mesh both --jobs 6
    python -m repro_torch.launch.dryrun --arch mamba2_370m --shape decode_32k

Where JAX lowers and compiles each cell for a 16 x 16 (or 2 x 16 x 16) TPU
mesh and reads XLA's cost and memory analyses, the port runs its own eager
step once on meta tensors: nothing is allocated or computed, every op runs
its shape function, and the count is what the same step does on the card.
Per-device numbers divide by the logical mesh (:mod:`.mesh`,
:mod:`repro_torch.sharding`):

  * ``flops_per_device`` is the count / chips: ideal partitioning. The meta
    run executes every chunk of the chunked attention and every SSD chunk
    (B5's registered count is nc chunk bodies), so JAX's
    ``inner_scan_correction`` (kept in the record, from the ported
    formula) is not added.
  * ``flops_total_masked`` and ``roofline.t_compute_masked``: where B4
    runs (``--set attention_impl=pallas``), the count with its calls at the
    (query, key) pairs their masks keep; B4's registered count is JAX's
    unmasked convention, about twice a causal kernel's work.
  * ``hbm_bytes_per_device`` is JAX's analytic model
    (:func:`analytic_hbm_bytes`); ``hbm_bytes_counted`` (the twin of
    ``hbm_bytes_xla_raw``) is the per-op bytes an eager run moves / chips.
  * ``memory``: the resident state per device under the specs (params,
    AdamW's moments, decode caches, the batch) plus the step's peak of
    live bytes on the meta device divided by the batch-shard width.
  * ``collectives`` and ``t_collective`` are null: XLA's partitioned HLO
    has no counterpart in an eager run, whose collectives would be the NCCL
    kernels of a ``torch.distributed`` run's profiler trace.

As in JAX, the layer stacks are homogeneous, so each cell runs at the two
depths of :func:`cost_depths` and extrapolates linearly to full depth
(:func:`_extrapolate`); the ends (embedding, logits, optimizer) cancel.
Train steps run their true gradient accumulation (``MICROBATCHES``).
Nothing here sets an environment variable or touches a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import config as C
from repro_torch import sharding as SH
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import hw
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import zoo
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step

# Gradient-accumulation factors for train_4k (JAX's; keys absent -> 1).
MICROBATCHES = {
    "mistral_large_123b": 16,
    "mixtral_8x22b": 8,
    "command_r_35b": 8,
    "granite_20b": 8,
    "stablelm_12b": 16,
    "zamba2_2p7b": 4,
    "qwen2_vl_2b": 4,
    "granite_moe_3b": 4,
    "whisper_large_v3": 4,
    "mamba2_370m": 2,
}

# paper-faithful baseline knobs applied to every cell (JAX's)
BASE_OVERRIDES = {"attn_chunk": 2048}


def cost_depths(cfg):
    """(L1-overrides, L2-overrides, n_units_full, n_units(L1), n_units(L2)) for
    the two cost runs. Layer stacks are homogeneous, so the difference of two
    depths gives the exact per-unit cost (the embed/logits ends cancel);
    hybrid uses whole groups and enc-dec uses (enc,dec) pairs."""
    if cfg.family == "hybrid":
        k = cfg.attn_every
        g_full = cfg.num_layers // k
        return ({"num_layers": k}, {"num_layers": 2 * k}, g_full, 1, 2)
    if cfg.is_encoder_decoder:
        return (
            {"num_layers": 2, "encoder_layers": 2},
            {"num_layers": 4, "encoder_layers": 4},
            cfg.num_layers, 2, 4,
        )
    l1 = min(2, cfg.num_layers)
    l2 = min(6, cfg.num_layers)
    if l1 == l2:
        l1 = 1
    return ({"num_layers": l1}, {"num_layers": l2}, cfg.num_layers, l1, l2)


def _materialize(spec: torch.Tensor, cfg, gen: torch.Generator) -> torch.Tensor:
    """A seeded input of ``spec``'s shape and dtype on ``gen``'s device:
    tokens below the vocabulary, stubbed embeddings normal * 0.02."""
    if spec.dtype == torch.int32:
        return torch.randint(0, cfg.vocab_size, tuple(spec.shape), generator=gen,
                             device=gen.device, dtype=torch.int32)
    return (torch.randn(tuple(spec.shape), generator=gen, device=gen.device)
            * 0.02).to(spec.dtype)


def cell_config(arch: str, shape_name: str, mesh, *, overrides=None,
                global_batch: int | None = None, seq_len: int | None = None, cfg=None):
    """(cfg, shape, mb) of a cell, JAX's ``build_cell`` overrides applied:
    ``kv_replication`` (decode, GQA heads short of the TP width) and
    ``moe_groups`` (the DP width). JAX's microbatch fold and its
    ``scan_layers`` switch serve XLA, which counts a loop body once; the
    eager meta run counts every microbatch and every layer, so the port has
    neither. ``global_batch`` and ``seq_len`` cut the shape (a card check's
    cut, a test's size); ``cfg`` replaces the arch's config (a smoke
    config)."""
    cfg = C.get_config(arch) if cfg is None else cfg
    shape = C.SHAPES[shape_name]
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=int(global_batch))
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=int(seq_len))
    mi = SH.mesh_info(mesh)
    dp = 1
    for a in mi.batch_axes:
        dp *= mi.axis_sizes[a]

    over = dict(overrides or {})
    mb_override = over.pop("microbatches", None)
    mb = mb_override or (MICROBATCHES.get(arch, 1) if shape.kind == "train" else 1)
    if shape.kind == "decode":
        KV = cfg.num_kv_heads
        if KV and SH.head_mode(cfg, mi.tp) == "heads_qonly" and mi.tp % KV == 0:
            over.setdefault("kv_replication", mi.tp // KV)
    if cfg.num_experts:
        over.setdefault("moe_groups", min(dp, shape.global_batch))
    return dataclasses.replace(cfg, **over), shape, mb


def build_cell(arch: str, shape_name: str, mesh, *, overrides=None, device="meta",
               global_batch: int | None = None, seq_len: int | None = None, cfg=None,
               seed: int = 0):
    """(cfg, shape, step, args, mb) for a cell (:func:`cell_config`): the
    train step (forward, backward and AdamW over ``mb`` microbatches, the
    true gradient accumulation), the prefill step or the decode step, and
    its arguments on ``device`` (meta: shapes only; another device: random
    params and inputs from ``seed``)."""
    cfg, shape, mb = cell_config(arch, shape_name, mesh, overrides=overrides,
                                 global_batch=global_batch, seq_len=seq_len, cfg=cfg)
    api = zoo.build(cfg)

    dev = torch.device(device)
    params = api.init_params(seed, device=dev)
    batch = zoo.input_specs(cfg, shape)
    if dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        batch = {k: _materialize(v, cfg, gen) for k, v in batch.items()}

    if shape.kind == "train":
        step = make_train_step(api, AdamWConfig(), microbatches=mb)
        args = (params, adamw_init(params), batch)
    elif shape.kind == "prefill":
        step = torch.no_grad()(make_prefill_step(api, max_len=shape.seq_len))
        args = (params, batch)
    else:  # decode
        caches = api.init_decode_state(shape.global_batch, max_len=shape.seq_len + 1,
                                       prefill_len=shape.seq_len, device=dev)
        step = torch.no_grad()(make_decode_step(api))
        args = (params, caches, batch["tokens"])
    return cfg, shape, step, args, mb


# ---------------------------------------------------------------------------
# counting one run
# ---------------------------------------------------------------------------
_ALLOC_ONLY = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _granule(n: int) -> int:
    """Bytes the CUDA caching allocator gives a request of ``n`` bytes: a
    multiple of 512 (0 for none)."""
    return -(-n // 512) * 512


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements a tensor view reaches (a
    broadcast dim of stride 0 reads its elements once)."""
    n = t.element_size()
    for s, st in zip(t.shape, t.stride()):
        if st != 0:
            n *= s
    return n


def _tensors(tree):
    """Every tensor in a tree, inside dataclasses (the caches) too."""
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            yield x
        elif dataclasses.is_dataclass(x):
            yield from _tensors([getattr(x, f.name) for f in dataclasses.fields(x)])


class Traffic(TorchDispatchMode):
    """Live storage bytes and their peak, and the bytes every op reads and
    writes, over one run. A storage counts from the op that makes it until
    it is freed (``weakref.finalize`` on the storage), rounded as the CUDA
    caching allocator rounds; storages alive before the run (:meth:`resident`)
    never count. View ops and bare allocations move no bytes. ``unkept``
    sums, over B4's calls, the registered count less the pairs its mask
    keeps (:func:`fa_ops.flops_masked`)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.moved = self.unkept = 0
        self._seen: dict[int, int] = {}

    def resident(self, tree) -> None:
        for t in _tensors(tree):
            self._seen[t.untyped_storage()._cdata] = 0

    def _free(self, key: int, n: int) -> None:
        if self._seen.get(key) == n:
            del self._seen[key]
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.ops.repro_torch.flash_attention.default:
            q, k, _, causal, window = args[:5]
            self.unkept += (fa_ops.flops(q.shape, k.shape)
                            - fa_ops.flops_masked(q.shape, k.shape, causal, window))
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._seen:
                n = _granule(st.nbytes())
                self._seen[key] = n
                self.live += n
                weakref.finalize(st, self._free, key, n)
        if self.live > self.peak:
            self.peak = self.live
        if not func.is_view and func.__name__.split(".")[0] not in _ALLOC_ONLY:
            ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.moved += sum(_distinct_bytes(t) for t in ins + outs)
        return out


def count_step(step, args) -> dict:
    """Run ``step(*args)`` once under ``FlopCounterMode`` inside a
    :class:`Traffic` mode: total FLOPs, FLOPs by op, the total with B4's
    calls at the pairs their masks keep (``flops_masked``), bytes moved,
    the peak of live bytes the run allocated, and its host seconds."""
    traffic = Traffic()
    traffic.resident(args)
    fc = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with fc, traffic:
        out = step(*args)
    del out
    by_op = {str(k): int(v) for k, v in fc.get_flop_counts().get("Global", {}).items()}
    flops = float(fc.get_total_flops())
    return {"flops": flops, "flops_by_op": by_op, "flops_masked": flops - traffic.unkept,
            "bytes": float(traffic.moved), "peak": float(traffic.peak),
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the analytic formulas (JAX's, unchanged)
# ---------------------------------------------------------------------------
def model_flops(cfg, shape, mb) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train (N = active params for MoE),
    2*N*D for forward-only (prefill/decode). shape is PRE-microbatch-fold."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def inner_scan_correction(cfg, shape, mb) -> float:
    """JAX's analytic TOTAL-FLOPs correction for the loop bodies XLA's
    HloCostAnalysis counts once:

      * online-softmax chunked attention (S >= attn_chunk): missing
        4*B*hd*H*(S*T - bq*bk) per attention call
      * SSD chunk scan: missing (nc-1) x per-chunk body per Mamba2 layer

    Training multiplies by 4 (fwd + remat recompute + ~2x bwd); forward-only
    by 1. The meta count needs no correction (module docstring); the record
    keeps it beside the count, for comparison with JAX's."""
    mult = 4.0 if shape.kind == "train" else 1.0
    B_eff = shape.global_batch // (mb if shape.kind == "train" else 1)
    S = shape.seq_len if shape.kind != "decode" else 1
    total = 0.0
    # chunked attention
    if shape.kind in ("train", "prefill") and cfg.num_heads:
        bq = bk = cfg.attn_chunk
        if cfg.attn_chunk and S >= cfg.attn_chunk:
            T_len = S
            H, hd = cfg.num_heads, cfg.resolved_head_dim
            per_call = 4.0 * B_eff * hd * H * (S * T_len - bq * bk)
            if cfg.family == "hybrid":
                ncalls = cfg.num_layers // cfg.attn_every
            elif cfg.family == "audio":
                ncalls = cfg.num_layers  # decoder self-attn (encoder is 1500)
            else:
                ncalls = cfg.num_layers
            total += per_call * ncalls
    # SSD chunks
    if cfg.ssm_state and shape.kind in ("train", "prefill"):
        Q = min(cfg.ssm_chunk, S)
        nc = max(S // Q, 1)
        if nc > 1:
            G_, N_ = cfg.ssm_groups, cfg.ssm_state
            H_, P_ = cfg.ssm_heads, cfg.ssm_head_dim
            body = B_eff * (
                2.0 * Q * Q * G_ * N_       # C.B scores
                + 2.0 * Q * Q * H_ * P_     # y_intra
                + 2.0 * Q * H_ * N_ * P_    # y_inter
                + 2.0 * Q * H_ * N_ * P_    # state update
            )
            total += (nc - 1) * body * cfg.num_layers
    return total * mult * (mb if shape.kind == "train" else 1)


def _linear(a, b, u1, u2, u_full):
    per = (b - a) / max(u2 - u1, 1)
    return max(a + per * (u_full - u1), 0.0)


def _extrapolate(c1, c2, u1, u2, u_full):
    """Linear-in-depth extrapolation of per-device costs from two depths
    (exact for homogeneous layer stacks: the ends cancel)."""
    def ex(a, b):
        return _linear(a, b, u1, u2, u_full)

    coll_keys = set(c1["coll"]) | set(c2["coll"])
    return {
        "flops": ex(c1["flops"], c2["flops"]),
        "bytes": ex(c1["bytes"], c2["bytes"]),
        "coll": {
            k: ex(c1["coll"].get(k, 0.0), c2["coll"].get(k, 0.0))
            for k in coll_keys
        },
    }


def analytic_hbm_bytes(cfg, shape, mb, mi) -> float:
    """JAX's per-device-per-step HBM traffic model (EXPERIMENTS.md
    §Roofline), unchanged: FSDP-gathered weight traffic, optimizer pass,
    per-layer activation streams, dense-attention score streams (only when
    the dense path is used), logits, KV/SSM cache traffic."""
    dp = 1
    for a in mi.batch_axes:
        dp *= mi.axis_sizes[a]
    tp = mi.tp
    P = cfg.param_count()
    B, S = shape.global_batch, shape.seq_len
    Vp, D = cfg.padded_vocab, cfg.d_model
    L = cfg.num_layers

    if shape.kind == "decode":
        # weight-read bound: every active weight read once per token step
        w = cfg.active_param_count() / (dp * tp) * 2
        cache = 0.0
        if cfg.num_heads:
            T = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
            KVh = cfg.num_kv_heads * cfg.kv_replication
            kv_shard = tp if (KVh % tp == 0) else (
                tp if cfg.resolved_head_dim % tp == 0 else 1)
            ncaches = (L // cfg.attn_every) if cfg.family == "hybrid" else L
            cache += (B / dp) * T * KVh * cfg.resolved_head_dim * 2 * 2 \
                * ncaches / kv_shard
            if cfg.is_encoder_decoder:
                cache += (B / dp) * cfg.encoder_seq * KVh \
                    * cfg.resolved_head_dim * 2 * 2 * L / kv_shard
        if cfg.ssm_state:
            h_shard = tp if cfg.ssm_heads % tp == 0 else 1
            cache += (B / dp) * cfg.ssm_heads * cfg.ssm_state \
                * cfg.ssm_head_dim * 4 * L / h_shard
        logits = (B / dp) * Vp / tp * 4
        return w + cache + logits

    passes = 3.0 if shape.kind == "train" else 1.0
    B_micro = B // (mb if shape.kind == "train" else 1)
    tok_loc = B_micro * S / dp
    # FSDP-gathered weights: one gathered copy per pass per microbatch
    weights = (P / tp) * 2 * (passes + 1)
    # activations: ~alpha streamed [tok, D] tensors per layer per pass
    alpha = 16 if cfg.num_experts else 10
    acts = alpha * tok_loc * D * 2 * passes * L
    # dense-attention scores hit HBM only when the dense path is used
    scores = 0.0
    if cfg.num_heads and (not cfg.attn_chunk or S < cfg.attn_chunk):
        H_loc = cfg.num_heads / (tp if cfg.num_heads % tp == 0 else 1)
        ncalls = (L // cfg.attn_every) if cfg.family == "hybrid" else L
        scores = 2 * (B_micro / dp) * H_loc * S * S * 4 * passes * ncalls
    logits = tok_loc * (Vp / tp) * 4 * passes
    per_micro = acts + scores + logits + weights
    total = per_micro * (mb if shape.kind == "train" else 1)
    if shape.kind == "train":
        total += P / (dp * tp) * 4 * 6  # optimizer read/write p,m,v
    return total


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------
def resident_bytes(cfg, shape, args, mi) -> dict:
    """Per-device bytes of what a step holds before it runs, under the
    specs: params, AdamW's state (moments under the params' specs; the
    count replicated), decode caches (in JAX's layout), the batch."""
    params = args[0]
    pspecs = SH.param_pspecs(cfg, params, mi)
    out = {"params_bytes": SH.tree_bytes_per_device(params, pspecs, mi),
           "optimizer_bytes": 0, "grads_bytes": 0, "caches_bytes": 0}
    if shape.kind == "train":
        opt = args[1]
        out["optimizer_bytes"] = (2 * out["params_bytes"]
                                  + opt["count"].numel() * opt["count"].element_size())
        out["grads_bytes"] = out["params_bytes"]
        batch = args[2]
    elif shape.kind == "prefill":
        batch = args[1]
    else:
        layout = SH.cache_layout(args[1])
        out["caches_bytes"] = SH.tree_bytes_per_device(
            layout, SH.cache_pspecs(cfg, layout, mi), mi)
        batch = {"tokens": args[2]}
    out["batch_bytes"] = SH.tree_bytes_per_device(batch, SH.batch_pspecs(cfg, batch, mi), mi)
    return out


def batch_shard_width(shape, mi) -> int:
    """How many ways the batch splits (1 where the batch does not divide
    the DP width, as ``sharding._ba`` leaves it replicated)."""
    width = 1
    for a in mi.batch_axes:
        width *= mi.axis_sizes[a]
    return width if shape.global_batch % width == 0 else 1


def measure(arch, shape_name, mesh, *, overrides=None, cache=None):
    """The record of one cell on ``mesh`` (no file written): two meta runs
    at :func:`cost_depths`' depths (cached in ``cache`` by config, batch
    and depth, so meshes that build the same config share them),
    extrapolated to full depth."""
    mi = SH.mesh_info(mesh)
    nchips = mesh.size
    cache = {} if cache is None else cache
    overrides = {**BASE_OVERRIDES, **(overrides or {})}
    cfg_full, shape_full, _, args_full, mb = build_cell(arch, shape_name, mesh,
                                                       overrides=overrides)
    res = resident_bytes(cfg_full, shape_full, args_full, mi)
    del args_full
    o1, o2, u_full, u1, u2 = cost_depths(cfg_full)

    def run(o):
        cfg, shape, step, args, _ = build_cell(arch, shape_name, mesh,
                                               overrides={**overrides, **o})
        key = (repr(cfg), repr(shape))
        if key not in cache:
            cache[key] = count_step(step, args)
        return cache[key]

    c1, c2 = run(o1), run(o2)
    ext = _extrapolate({"flops": c1["flops"], "bytes": c1["bytes"], "coll": {}},
                       {"flops": c2["flops"], "bytes": c2["bytes"], "coll": {}},
                       u1, u2, u_full)
    peak = _linear(c1["peak"], c2["peak"], u1, u2, u_full)
    masked = _linear(c1["flops_masked"], c2["flops_masked"], u1, u2, u_full)
    by_op = {k: _linear(c1["flops_by_op"].get(k, 0), c2["flops_by_op"].get(k, 0),
                        u1, u2, u_full)
             for k in sorted(set(c1["flops_by_op"]) | set(c2["flops_by_op"]))}

    flops_dev = ext["flops"] / nchips
    bytes_dev = analytic_hbm_bytes(cfg_full, shape_full, mb, mi)
    corr_total = inner_scan_correction(cfg_full, shape_full, mb)
    mf = model_flops(cfg_full, shape_full, mb)
    width = batch_shard_width(shape_full, mi)
    argument = (res["params_bytes"] + res["optimizer_bytes"] + res["caches_bytes"]
                + res["batch_bytes"])
    temp = peak / width
    rec = {
        "arch": arch,
        "shape": shape_name,
        "chips": int(nchips),
        "microbatches": mb,
        "global_batch": shape_full.global_batch,
        "params": cfg_full.param_count(),
        "active_params": cfg_full.active_param_count(),
        "count_s": {"l1": round(c1["seconds"], 2), "l2": round(c2["seconds"], 2)},
        "cost_extrapolation": {"u1": u1, "u2": u2, "u_full": u_full},
        "flops_total": ext["flops"],
        "flops_by_op_total": by_op,
        "flops_per_device_raw": flops_dev,
        "flops_per_device": flops_dev,
        "partitioning": "ideal: the meta count of the whole step / chips",
        "flops_total_masked": masked,
        "flops_masked_note": "flops_total with B4's calls at the (query, key) pairs their "
                             "causal / window masks keep (the kernel skips the tiles past "
                             "the mask; the plain chunked form computes every block, so "
                             "without B4 the two are equal)",
        "inner_scan_correction_total": corr_total,
        "inner_scan_correction_note": "JAX's formula, not added: the meta run counts every chunk",
        "hbm_bytes_per_device": bytes_dev,
        "hbm_bytes_counted": ext["bytes"] / nchips,
        "collectives": None,
        "collectives_note": "no partitioned HLO in an eager run; the twin reads the NCCL "
                            "kernels of a torch.distributed run's trace",
        "model_flops_total": mf,
        "memory": {
            **res,
            "argument_bytes": argument,
            "step_peak_bytes": peak,
            "batch_shard_width": width,
            "temp_bytes": temp,
            "peak_est_bytes": argument + temp,
            "note": "resident state under the specs + the meta run's peak of live "
                    "bytes / the batch-shard width; the step allocates its gradients, "
                    "so grads_bytes is inside temp_bytes",
        },
    }
    rec["memory"]["fits"] = rec["memory"]["peak_est_bytes"] <= hw.HBM_PER_CHIP
    rec["roofline_valid"] = True
    roof = {
        "t_compute": flops_dev / hw.PEAK_FLOPS_BF16,
        "t_compute_masked": masked / nchips / hw.PEAK_FLOPS_BF16,
        "t_memory": bytes_dev / hw.HBM_BW,
        "t_collective": None,
        "t_dcn": None,
        "useful_flops_ratio": mf / max(flops_dev * nchips, 1.0),
    }
    roof["dominant"] = max((k for k in ("t_compute", "t_memory", "t_collective")
                            if roof[k] is not None), key=lambda k: roof[k])
    rec["roofline"] = roof
    rec["hw"] = {"card": "NVIDIA H100 SXM (spec sheet)", "peak_flops_bf16": hw.PEAK_FLOPS_BF16,
                 "hbm_bw": hw.HBM_BW, "hbm_per_chip": hw.HBM_PER_CHIP}
    return rec


def host_check(arch, shape_name, *, overrides=None, global_batch=None,
               doubled: bool = False, cfg=None, seq_len=None) -> dict:
    """The meta side of checking a cell against real steps on one card (a
    1 x 1 host mesh, the batch cut to ``global_batch``): at each of
    :func:`cost_depths`' two depths and at full depth, the count (FLOPs,
    FLOPs by op), the resident bytes, the peak of live bytes and their sum
    ``peak_est_bytes``; at the two depths the roofline terms too. With
    ``doubled``, also ``peak_est_bytes`` at the deeper depth with twice the
    batch: the evidence for the cut. ``cfg`` and ``seq_len`` as in
    :func:`cell_config`. JSON-ready."""
    mesh = make_host_mesh(1, 1)
    mi = SH.mesh_info(mesh)
    overrides = {**BASE_OVERRIDES, **(overrides or {})}
    base = cfg
    cfg_full, *_ = cell_config(arch, shape_name, mesh, overrides=overrides,
                               global_batch=global_batch, seq_len=seq_len, cfg=base)
    o1, o2, u_full, u1, u2 = cost_depths(cfg_full)

    def at(o, batch):
        cfg, shape, step, args, mb = build_cell(arch, shape_name, mesh,
                                                overrides={**overrides, **o},
                                                global_batch=batch, seq_len=seq_len, cfg=base)
        res = resident_bytes(cfg, shape, args, mi)
        c = count_step(step, args)
        del args
        resident = sum(res[k] for k in ("params_bytes", "optimizer_bytes", "caches_bytes",
                                        "batch_bytes"))
        return {"num_layers": cfg.num_layers, "global_batch": shape.global_batch, "mb": mb,
                "flops": c["flops"], "flops_by_op": c["flops_by_op"],
                "flops_masked": c["flops_masked"], "peak": c["peak"],
                "resident": resident, "peak_est_bytes": resident + c["peak"],
                "t_compute": c["flops"] / hw.PEAK_FLOPS_BF16,
                "t_compute_masked": c["flops_masked"] / hw.PEAK_FLOPS_BF16,
                "t_memory": analytic_hbm_bytes(cfg, shape, mb, mi) / hw.HBM_BW,
                "count_s": c["seconds"]}

    depth = {"l1": o1, "l2": o2, "full": {"num_layers": cfg_full.num_layers,
                                          "encoder_layers": cfg_full.encoder_layers}}
    out = {"arch": arch, "shape": shape_name, "overrides": overrides,
           "u1": u1, "u2": u2, "u_full": u_full}
    out.update({lv: at(o, global_batch) for lv, o in depth.items()})
    if doubled:
        batch = C.SHAPES[shape_name].global_batch if global_batch is None else global_batch
        out["l2_doubled"] = at(o2, 2 * batch)
    return out


def summary(rec) -> str:
    m, r = rec["memory"], rec["roofline"]
    return (f"[dryrun] {rec['arch']:>20s} {rec['shape']:>11s} {rec['mesh']:>6s} "
            f"flops/dev={rec['flops_per_device']:.3e} "
            f"mem={m['peak_est_bytes'] / 2**30:8.2f}GiB dom={r['dominant'][2:]} "
            f"fits={m['fits']} t_c={r['t_compute']:.4g}s t_m={r['t_memory']:.4g}s "
            f"useful={r['useful_flops_ratio']:.2f} "
            f"count=({rec['count_s']['l1']:.1f}+{rec['count_s']['l2']:.1f})s")


def run_cell(arch, shape_name, mesh_name, outdir, *, overrides=None, tag="", cache=None):
    """:func:`measure` on the production mesh ``mesh_name`` (``"single"``:
    16 x 16, ``"multi"``: 2 x 16 x 16), written to ``outdir`` under JAX's
    file name and printed as one line."""
    mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    rec = measure(arch, shape_name, mesh, overrides=overrides, cache=cache)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, **rec, "tag": tag}
    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape_name}__{mesh_name}{('__' + tag) if tag else ''}.json"
    (out / name).write_text(json.dumps(rec, indent=1))
    return rec


def _run_cell_meshes(a, s, meshes, outdir, overrides, tag):
    """Every mesh of one cell in one process, sharing the meta runs.
    Returns [(mesh, summary line or None, error or None)]."""
    cache, out = {}, []
    for m in meshes:
        try:
            rec = run_cell(a, s, m, outdir, overrides=overrides, tag=tag, cache=cache)
            out.append((m, summary(rec), None))
        except Exception as e:  # noqa: BLE001
            out.append((m, None, f"{e!r}\n{traceback.format_exc()}"))
    return out


def _parse_sets(items) -> dict:
    overrides = {}
    for kv in items:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                try:
                    overrides[k] = float(v)
                except ValueError:
                    overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(description="meta-device dry run of the (arch x shape) grid")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--tag", default="", help="artifact tag (variants)")
    ap.add_argument(
        "--set", action="append", default=[],
        help="ModelConfig override key=val (e.g. --set attention_impl=pallas)",
    )
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, one process each")
    args = ap.parse_args(argv)
    overrides = _parse_sets(args.set)

    cells = list(C.cells(include_skipped=True))
    if args.list:
        for a, s, skip in cells:
            print(f"{a:>20s} {s:>11s} {'SKIP: ' + skip if skip else 'run'}")
        return

    todo = []
    for a, s, skip in cells:
        if args.arch and a != C.ALIASES.get(args.arch, args.arch):
            continue
        if args.shape and s != args.shape:
            continue
        if not args.all and not args.arch and not args.shape:
            continue
        todo.append((a, s, skip))

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out = pathlib.Path(args.out)
    failures = []
    t0 = time.perf_counter()
    runs = [(a, s) for a, s, skip in todo if not skip]
    for a, s, skip in todo:
        if skip:
            print(f"[dryrun] {a:>20s} {s:>11s}  SKIPPED: {skip}", flush=True)
            out.mkdir(parents=True, exist_ok=True)
            (out / f"{a}__{s}__skip.json").write_text(
                json.dumps({"arch": a, "shape": s, "skipped": skip}))
    common = (meshes, args.out, overrides, args.tag)
    if args.jobs > 1 and len(runs) > 1:
        ctx = multiprocessing.get_context("fork")
        with concurrent.futures.ProcessPoolExecutor(args.jobs, mp_context=ctx) as ex:
            futs = [ex.submit(_run_cell_meshes, a, s, *common) for a, s in runs]
            results = [f.result() for f in futs]
    else:
        results = [_run_cell_meshes(a, s, *common) for a, s in runs]
    for (a, s), res in zip(runs, results):
        for m, line, err in res:
            if err is None:
                print(line, flush=True)
            else:
                failures.append((a, s, m, err.splitlines()[0]))
                print(f"[dryrun] FAIL {a} {s} {m}: {err}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {failures}")
    print(f"[dryrun] {len(runs)} cells x {len(meshes)} mesh(es) counted, "
          f"{len(todo) - len(runs)} skipped, in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
