#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # all phases, one card, exits 0 on success

Drives the port's main paths (``repro_torch``: R-TBS and the paper's other
schemes + linreg retrain + prequential eval through ``make_sampler`` /
``make_model`` / ``materialize_stream`` / ``make_run_loop``, with and
without the adaptive decay controller, Monte-Carlo farms through
``make_run_farm``, the keyed R-TBS and T-TBS sampler banks through
``make_bank`` / ``make_bank_run_loop``, the key-sharded bank through
``shard_keyed_stream`` / ``make_sharded_bank_loop``, and batched
LM serving of every family of the zoo (dense, Mamba2, MoE, vlm, hybrid,
encoder-decoder) through
``repro_torch.launch.serve.serve_batch``) at full state and model size, and
the dry run of the (arch x shape) grid with four of its cells checked
against real steps, after building every CUDA kernel from ``src/repro_torch/kernels/csrc`` and holding
each against its plain PyTorch version on the card. Imports neither JAX nor
the JAX package. Every check raises on failure; no phase catches its own.

  1. environment: card name and power limit, versions, kernel build time;
  2. kernels B1 (tbs_step_apply), B2 (reservoir_compact) and H1
     (swap_delete) against their plain versions at the main path's shapes,
     with CUDA-event times, the memory bound and, for B1, one
     ``torch.index_select`` as the library yardstick (for B2, ``items[mask]``);
     B2 on the main path's x + y leaves in one launch on a uniform, a
     prefix and a block-sparse mask; B1 per dtype, every
     dtype as one pytree in one launch, and the main tick's x + y leaves in
     one launch, timed beside the single-launch bound and a ``copy_`` of
     the same bytes; H1 at L = 2^20 with
     4,096, 32,768 and 65,536 trips (its forest route) and at the bank's
     65,536 rows of L = 65 and 97 (its rows route), with launches by route;
  3. the main path at cap = 2^20: branch schedule, W recurrence, launch
     counts (B1 once a tick), a tick under ``set_sync_debug_mode("error")``, B2 through
     ``materialize_view`` (one launch), ticks per second and a profiled tick;
  4. the same path at cap = 4096 on the card and on the CPU: bit for bit;
  5. naive_bayes on a 100-word bag-of-words stream;
  6. the keyed bank (``make_bank`` / ``make_bank_run_loop``) at K = 2^20
     tenants, n = 64, b = 65,536 arrivals a tick: ticks and keyed items per
     second, B3 (tbs_step_apply_banked) launched once a tick and equal to
     its plain version, the [K] columns' W recurrence and pending product
     on every tick, a tick under ``set_sync_debug_mode("error")``, a
     profiled retrain tick, B3's time (x + y in one launch) against its
     bound, the bytes its design moves and the unfused composition, and
     card == CPU at K = 4096;
  7. serving: ``stablelm_12b`` at full width and depth (40 layers, bf16
     params, B4 flash attention), 8 prompts x 2,048 tokens prefilled and
     32 tokens decoded greedily, with exactly 40 B4 launches in the prefill,
     all on B4's tensor-core route (bf16), and none in decode; B4 against
     its plain version at the prefill's shape, at bf16 shapes of every
     head-dim layout, mask, group, ragged and S != T length and a fused
     projection's views (the tensor-core kernel; each row also against the
     f32 reference), and at f32 GQA / MQA / window / non-causal shapes (the
     CUDA-core kernel); B4's time beside its bound, its plain version and
     ``scaled_dot_product_attention``;
     a profiled prefill and decode step by scope; and, at 2 layers of full
     width in f32 (that depth cut is (c)'s and (d)'s only), card == CPU
     and teacher-forced decode == forward;
  8. Mamba2 serving: ``mamba2_370m`` at full width and depth (48 layers,
     bf16 params, B5 SSD chunked scan), SSM_PROMPTS prompts x 32,768
     tokens prefilled and 32 tokens decoded greedily, with exactly 48 B5
     launches in the prefill, all on B5's tensor-core route (bf16), and
     none in decode; B5 against its plain version at the prefill's shape
     (bf16, the tensor-core kernel; the last prompt's rows also against
     the f32 recurrence), again on its first 4 prompts (the timed shape,
     bit for bit the served call's; each row against the recurrence), at
     bf16 shapes of other groups, widths, ragged
     chunks and a carried state, and against the per-token recurrence in f32
     (the CUDA-core kernel: G = 2, distinct A per head, Q 64 / 96 / 256,
     init_state, strided views); B5's time at 4 prompts beside its bound,
     its plain version and the CUDA-core kernel's on the same shape in f32;
     a profiled prefill and decode step by scope; and, at 2 layers of full
     width in f32 (that depth cut is (e)'s only), card == CPU and
     teacher-forced decode == forward;
  9. the paper's other schemes (``make_sampler("ttbs" | "btbs" | "brs" |
     "sw")``) through ``make_run_loop`` on phase 3's stream: T-TBS with
     n = 2^20, lam 0.03, batch_size 65,536 (q = 0.4729), cap 2^22; B-TBS,
     cap 2^22; B-RS and SW with n = 2^20. For each: ticks per second,
     B1 exactly once a tick, H2 (binomial) once a tick for T-TBS / B-TBS,
     H3 (hypergeometric) once a tick for B-RS, nothing else; SW holds the
     newest min(n, seen) rows in arrival order, B-RS min(n, seen) rows and
     W = seen, T-TBS / B-TBS W_t = p W_(t-1) + B_t (one rounding) exactly,
     no overflow and every size within 6 sqrt(E_t) + 1 of its mean;
     ``materialize_view`` packs the sample (B2, one launch); a tick under
     ``set_sync_debug_mode("error")``; a profiled retrain tick of T-TBS and
     of B-RS by scope. (b) each scheme at n = 4,095 on the card and the
     CPU, bit for bit. (c) H2 and H3 against their plain versions on
     65,536-row sweeps (both of H2's routes, its edges and counts up to
     2^22; H3's supports up to 65,537) and H3 on its block-edge rows
     (hits on the first and last trip of its blocks, hi mid-block,
     supports of one block and one more trip, the guard) under five trips
     caps, their sample moments within 5 standard errors of the analytic
     ones (H3 at two main-path triples: of its f32 algorithm's own
     distribution, the reference being biased there, ROADMAP C.8), and
     (d) their times at the main path's shapes beside their bounds, their
     plain versions and, for H2, ``torch.binomial``; H3 at a saturated, a
     late and a first B-RS tick and on the 65,536-row sweep, each beside
     its chain floor (trips x 4 cycles at the top SM clock);
 10. closed-loop adaptive decay on the main cell: ``make_run_loop(...,
     controller=loss_ratio(lam0=0.03, lam_min=0.003, lam_max=0.5))`` over
     phase 3's stream with its coefficients flipped at tick 24, for R-TBS
     (n = 2^20 - 1) and for T-TBS and B-TBS at phase 9's sizes: lambda's
     path printed, below lam0 in the four ticks before the flip and past
     0.4 within two retrains after it; B1 once a tick (and H2 for T-TBS /
     B-TBS); the controlled ticks driven by hand equal the run bit for bit;
     a controlled tick under ``set_sync_debug_mode("error")``;
 11. a Monte-Carlo farm (``make_run_farm``) of 8 trials of the controlled
     main cell over 24 of phase 10's ticks (12-35, the flip at its tick 12;
     a depth cut), its trials a leading dimension of the sampler's state
     (B1 once a tick for all trials): bit for bit the 8 single runs
     stacked, every trial's lambda past 0.4 after the flip;
 12. the keyed T-TBS bank (``make_bank("ttbs", ...)``) at K = 2^20, n = 64,
     cap 256, bcap 32, lam 0.05, batch_size the stream's mean arrivals per
     touched key, on phase 6's Zipf(1.1) stream through
     ``make_bank_run_loop`` with per-key models and a per-key controller
     on the 64 train keys: ticks and keyed items per second, B3 and H2
     (the two binomials of all 65,536 routed rows) exactly once a tick and
     nothing else, W and pending of all K keys exact on every tick, the
     ticks by hand equal to the run, a tick under
     ``set_sync_debug_mode("error")``, a profiled retrain tick; H2 on a
     tick's 131,072 rows equal to its plain version and timed beside its
     bound, its plain version, ``torch.binomial`` and a one-row launch; B3
     at cap 256 equal to its plain version and timed beside its bound;
     and (d) card == CPU at K = 4096;
 13. the LM online-management driver (``repro_torch.launch.train``) at
     mamba2_370m's full size (48 layers, d 1,024, bf16 compute, f32 params
     and AdamW moments) under ``cfg.remat`` (each layer checkpointed),
     R-TBS over 512-token sequences, 64 a tick, n 4,096, a retrain of 8
     AdamW steps on 16 rows every 4 ticks, 8 ticks: eval finite and
     falling, W exact, B1 once a tick, B5 48 times a forward (each eval and
     fit step) and 48 times more in each fit step's backward (the
     recompute, counted apart), peak memory, seconds a retrain, fit
     tokens/s and ticks/s; a run through ``main`` at a depth cut of 4
     layers stopped at tick 4 (checkpoint, profiler trace) and resumed from
     its checkpoint to 8 equal to an unbroken run bit for bit, rows and final
     state; one layer's gradients through B5 within B5's bf16 tolerance of
     the plain route's; B5 timed at the fit's shape; one more fit step
     profiled by scope; (e) the last retrain tick (the run's, with remat)
     again from its starting state without remat: losses,
     params and AdamW moments bit for bit equal, both peaks and retrain
     times, B5's launches by forward, recompute and eval. (d) one retrain of 2
     steps at a depth cut of full width in f32, mamba2_370m (2 layers) and
     stablelm_12b (1 layer), card vs CPU from the same params and rows;
 14. the driver's bank mode (``--num-keys 16384``, R-TBS, 4 layers of
     mamba2_370m, 128-token items, bcap 32) with and without
     ``--telemetry-dir``: equal logs, B3 once a tick, the JSONL passing
     ``benchmarks/check_telemetry.py``;
 15. telemetry on the main cell (phase 3's stream at cap 2^20) through
     ``make_run_loop(..., telemetry=make_telemetry(dir, every=16))``: the
     outputs bit-identical to telemetry off, the records passing the schema
     check, fast ticks with their drains under
     ``set_sync_debug_mode("error")``, the rows' device ms and kernels a
     tick; a short serve run's ``query`` records;
 16. the distributed schemes (``make_sampler("drtbs" | "dttbs")``), the
     S = 8 reservoir shards a leading dimension of the card's state,
     through ``make_sharded_run_loop``: (a) D-R-TBS at n = 2^20, cap_s
     2^18, 65,536 arrivals a tick (8,192 a shard), 48 ticks: C_t and W_t
     exact in f32 on every tick, |S_t| in {floor C_t, floor C_t + 1},
     overflow 0, B1 once a tick for all shards, H3 2 S times a tick (two
     split chains), B2 once a retrain, nothing else; ticks per second
     beside phase 3's R-TBS, a tick under ``set_sync_debug_mode("error")``,
     a profiled retrain tick by scope; (b) card == CPU bit for bit at S = 4,
     cap_s 4,096, for drtbs and dttbs; (c) fused == per-tick == resumed at
     tick 24; (d) D-T-TBS on the same stream (n_s 2^17, cap 2^19 a shard):
     H2 and B1 once a tick, W exact per shard; (e) an 8-trial sharded farm
     at cap_s 4,096 over 24 ticks equal to its single runs, and the driver's ``--scheme
     drtbs --shards 8`` at phase 14's depth cut resumed from its checkpoint
     equal to the unbroken run byte for byte;
 17. the rest of the LM zoo through ``serve_batch``, each at full width in
     bf16 with 32 tokens generated: granite_moe_3b (MoE, 8 x 2,048), qwen2_vl_2b
     (256 patch embeddings + 1,792 tokens, 8 prompts), zamba2_2p7b (54
     Mamba2 layers and 9 invocations of the shared block, 8 x 8,192),
     whisper_large_v3 (8 x 1,500 frames, 224-token prompts) and
     mixtral_8x22b at a depth cut of 4 of its 56 layers (2 x 8,192, twice
     its window): B4 (and B5) launched the expected number of times in each
     prefill, all on the tensor cores, never in decode; a second prefill
     equal to the first bit for bit; a profiled prefill by scope. (b) B4 at
     each new served shape (hd 64, 80, 128; non-causal over 1,500 frames;
     window 4,096 at 8,192) and B5 at zamba2's (H 80, N 64, P 64) against
     their plain versions, timed beside their bounds, the plain versions
     and (B4) ``scaled_dot_product_attention``. (c) card == CPU per family
     in f32 at a depth cut of full width (MoE routes included) and
     teacher-forced decode == forward;
 18. the key-sharded bank loop (``shard_keyed_stream`` /
     ``make_sharded_bank_loop``): (a) phase 6's bank split by key ownership
     over KS_S = 8 shards of K_s = 2^17 keys (K = 2^20) on phase 6's Zipf
     stream, 32 ticks of 65,536 arrivals, timed in paired turns with phase
     6's local bank loop on the same stream (local, sharded, sharded,
     local): ticks and keyed items per second, each shard's mean arrivals
     a tick, bcap_s, the rows routed a tick, peak memory; B3 exactly once
     a tick for all shards, H1 on its rows route, sizes <= n, the overflow
     summed over shards equal to phase 6's tick by tick, the metric finite
     after tick 0 and equal on every shard, each tick's arrivals over the
     shards equal to the stream's; a profiled retrain tick by scope, a
     tick under ``set_sync_debug_mode("error")``, one step's routed rows
     accounted (accepted + dropped + invalid = the tick). (b) card == CPU
     at K = 4,096 over 4 shards for rtbs and ttbs, shared and per key
     (state, sizes and overflow bit for bit; params and metric within 1e-4,
     or bit for bit where they are); S = 1 equal to ``make_bank_run_loop``
     bit for bit; two shards fed the same sub-stream bit-identical (ROADMAP
     C.18). (c) ``compress_grads`` over mamba2_370m's parameter shapes card
     == CPU bit for bit; the four ``examples_torch/`` scripts run on the
     card as subprocesses, all started together, each exiting 0;
 19. the dry run (``repro_torch.launch.dryrun``) and the card against it:
     (a) ``python -m repro_torch.launch.dryrun --all --mesh single`` as a
     CPU subprocess on meta tensors: all 40 (arch x shape) cells, 33
     counted on the 16 x 16 mesh and 7 skipped, one line a cell (FLOPs a
     device, memory, the dominant term, whether it fits), the records in
     ``results/dryrun_torch/``; (b) four cells cut to the card (mamba2_370m
     train_4k at batch 16, stablelm_12b prefill_32k through B4 at batch 8,
     mamba2_370m prefill_32k through B5, stablelm_12b decode_32k at batch
     32; each cut printed beside what twice the batch would need) run at
     full width at ``cost_depths``' two depths: FlopCounterMode's total on
     the card equal to the meta count op by op, the extrapolation of the
     card's two counts equal to the meta count at full depth,
     ``max_memory_allocated`` within max(5 %, 1 GiB) of the meta
     ``peak_est_bytes`` on a 1 x 1 mesh, the median of five steps beside
     max(t_compute, t_memory) (and with B4's calls at the pairs their masks
     keep), one step profiled; (c) B4 and B5 through their registered ops
     bit for bit against a direct launch on the same inputs, the launch
     counters, and the host time a call of the wrapper, the op and a bare
     launch. (c) and (b)'s timed steps run first, while no subprocess of
     this script runs; the CPU counts then overlap the card's untimed
     counts at the deeper depth;
 20. the LM driver on the zoo's other families that train on tokens alone,
     granite_moe_3b (MoE, 32 layers, 40 experts top-8, 3.3 B params) and
     zamba2_2p7b (hybrid: 54 Mamba2 layers, a shared attention block every
     6), at full width and depth under remat, with phase 13's flags over 8
     ticks (two retrains): parameters and state bytes, ticks/s, seconds a
     retrain, fit tokens/s, eval loss by tick (finite), W exact, B1 once a
     tick, zamba2's B5 launches (54 an eval, 162 a fit step: the forward
     and the recomputes of its nested checkpoints), all tensor-core, one
     more fit step profiled by scope; (a) granite_moe_3b's first retrain
     replayed from the seed in a second run, bit for bit; (b) checkpoint and
     resume at a depth cut of full width (2 layers; zamba2 6, one group; 2
     AdamW steps a retrain), bit for bit, so each retrain of the cut runs
     twice from one state;
     (c) the peak beside the dry run's count of one fit step at the same
     shape (``dryrun.host_check`` in CPU subprocesses); (d) one retrain of
     the smoke config in f32, card vs CPU; (e) one MoE layer's backward,
     8 passes: one result with the dispatch's ordered backward, and how
     many with a plain gather's atomics. Phase 20 runs inside phase 19: its
     measured runs after phase 19's timed steps, while no subprocess runs;
     its checks (a)-(e) while phase 19's grid runs in CPU subprocesses;
 21. the Sec. 5 schemes with one reservoir shard a rank of a
     ``torch.distributed`` group (``repro_torch.launch.ranks``), every rank
     on the one card, against the stacked form at S = 4 in this process on
     the same key and stream: (a) D-R-TBS over 4 gloo ranks at phase 16's
     cell re-sharded (n = 2^20, 4 shards of 2^19 slots, 48 ticks of 65,536
     arrivals): rank 0's all-gathered final state, params and trace bit for
     bit, every rank's W_t / C_t from its ticks by hand exact against
     ``_drtbs_recurrence``, each rank's launches (B1 48, H3 2 x 4 x 48, B2
     12), ticks/s of both forms; (b) D-T-TBS the same way (H2 48); (c) the
     D-R-TBS loop over NCCL at world size 1 equal to the stacked form at
     S = 1, and a fast tick under ``set_sync_debug_mode("error")``; (d) the
     key-sharded bank at K = 2^20 over 4 gloo ranks, 16 ticks, each rank's
     digest equal to the stacked row's; (e) the LM driver under ``python -m
     torch.distributed.run --nproc-per-node 4`` (phase 16's flags at
     ``--shards 4``, gloo): 8 ticks unbroken, 4 then resumed to 8, logs and
     the step_8 checkpoint equal to the one-process run's; (f) the
     collectives of rank 0's profiled fast and retrain ticks of (a), by
     ``launch.comm_analysis.collective_stats``. Ranks run as child
     processes with a timeout; a rank that fails fails the phase;
 22. the ``kernels`` JSON line, the card line, and the result line.

``python3 chip_smoke.py --only 13,13d,14,15,16,17,18,19,20,21`` runs only the
listed phases of 13-21 (no kernels line, no result line).

f32 matrix products run in full f32: TF32 is switched off for matmul and
cuDNN before any model code runs.
"""
from __future__ import annotations

import json
import math
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# spec-sheet dense peaks (FLOP/s) of an H100 / H200 SXM: bf16 on the tensor
# cores, f32 on the CUDA cores (the port's f32 runs no TF32); filled from
# repro_torch/launch/hw.py, the one home of the spec-sheet numbers, once the
# checkout is on the path
PEAK: dict[str, float] = {}

N_MAIN, BCAP_MAIN, LAM = 1_048_575, 65_536, 0.03
RETRAIN_EVERY = 4

# B1, B3 and B2 on x + y before their one-launch designs (a launch per
# leaf): this script's phases 2 and 6 on an NVIDIA H100 80GB HBM3 at 700 W
B1_BEFORE_MS, B3_BEFORE_MS, B2_BEFORE_MS = 0.0351, 0.0506, 0.0482


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def hbm_for(name: str):
    """Spec-sheet device-memory bandwidth (bytes/s) and its label, by the
    name nvidia-smi reports (``hw.hbm_bw_for``)."""
    from repro_torch.launch import hw

    return hw.hbm_bw_for(name)


def max_abs_err(torch, a, b) -> float:
    if a.dtype == torch.bool:
        return float((a != b).any())
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
def phase_kernels(torch, timer, bw, reps):
    """Phase 2: each kernel against its plain version on the card."""
    from repro_torch.kernels.reservoir_compact import ops as rc_ops, ref as rc_ref
    from repro_torch.kernels.swap_delete import ops as sd_ops, ref as sd_ref
    from repro_torch.kernels.tbs_step import ops as ts_ops, ref as ts_ref

    cap, bcap = N_MAIN + 1, BCAP_MAIN
    g = torch.Generator(device="cuda").manual_seed(0)
    # int32, as rtbs.tick_map hands it to B1 on the main path
    src = torch.randint(0, cap + bcap, (cap,), generator=g, device="cuda",
                        dtype=torch.int32)
    cases = [("f32[.,2]", torch.float32, (2,)), ("f32[.]", torch.float32, ()),
             ("i32[.]", torch.int32, ()), ("bool[.]", torch.bool, ()),
             ("bf16[.]", torch.bfloat16, ()), ("f32[.,100]", torch.float32, (100,))]
    rows, pytree_items, pytree_batch = {}, {}, {}
    for name, dt, tail in cases:
        if dt == torch.bool:
            items = torch.rand((cap,) + tail, generator=g, device="cuda") < 0.5
            batch = torch.rand((bcap,) + tail, generator=g, device="cuda") < 0.5
        elif dt == torch.int32:
            items = torch.randint(-2**31, 2**31 - 1, (cap,) + tail, generator=g,
                                  device="cuda", dtype=torch.int32)
            batch = torch.randint(-2**31, 2**31 - 1, (bcap,) + tail, generator=g,
                                  device="cuda", dtype=torch.int32)
        else:
            items = torch.randn((cap,) + tail, generator=g, device="cuda").to(dt)
            batch = torch.randn((bcap,) + tail, generator=g, device="cuda").to(dt)
        got = ts_ops.tbs_step_apply(items, batch, src)
        want = ts_ref.apply_ref(items.reshape(1, cap, -1), batch.reshape(1, bcap, -1),
                                src[None]).reshape(items.shape)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"B1 {name} differs from its plain version")
        err = max_abs_err(torch, got, want)
        row_b = items[0].numel() * items.element_size()
        # each output row read once from its source and written once; src read once
        nbytes = 2 * cap * row_b + 4 * cap
        cat = torch.cat([items, batch])
        ms = timer(lambda: ts_ops.tbs_step_apply(items, batch, src), reps)
        plain = timer(lambda: ts_ref.apply_ref(items.reshape(1, cap, -1),
                                               batch.reshape(1, bcap, -1), src[None]),
                      reps)
        lib = timer(lambda: torch.index_select(cat, 0, src), reps)
        bound = nbytes / bw * 1e3
        rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                          err=err)
        pytree_items[name], pytree_batch[name] = items, batch
        print(f"[2] B1 tbs_step_apply {name:10s} equal  kernel {ms:.4f} ms  "
              f"plain {plain:.4f} ms  index_select {lib:.4f} ms  bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB)")
    # every case above as one pytree: one launch, each leaf bit for bit
    n0 = ts_ops.tbs_step_apply.launches
    got = ts_ops.tbs_step_apply(pytree_items, pytree_batch, src)
    torch.cuda.synchronize()
    check(ts_ops.tbs_step_apply.launches == n0 + 1, "B1 pytree of every dtype: one launch")
    for name in pytree_items:
        want = ts_ref.apply_ref(pytree_items[name].reshape(1, cap, -1),
                                pytree_batch[name].reshape(1, bcap, -1), src[None])
        check(torch.equal(got[name], want.reshape(got[name].shape)),
              f"B1 {name} in the one-launch pytree differs from its plain version")
    print(f"[2] B1 all {len(pytree_items)} dtype cases as one pytree: one launch, each "
          f"leaf equal to its plain version")
    del got, pytree_items, pytree_batch

    # the main path's two leaves, x f32[., 2] and y f32[.], in one call
    items = {"x": torch.randn((cap, 2), generator=g, device="cuda"),
             "y": torch.randn((cap,), generator=g, device="cuda")}
    batch = {"x": torch.randn((bcap, 2), generator=g, device="cuda"),
             "y": torch.randn((bcap,), generator=g, device="cuda")}
    n0 = ts_ops.tbs_step_apply.launches
    got = ts_ops.tbs_step_apply(items, batch, src)
    torch.cuda.synchronize()
    check(ts_ops.tbs_step_apply.launches == n0 + 1, "B1 x + y not in one launch")

    def plain_xy():
        return {f: ts_ref.apply_ref(items[f].reshape(1, cap, -1),
                                    batch[f].reshape(1, bcap, -1), src[None])
                for f in items}

    want = plain_xy()
    err = 0.0
    for f in items:
        w = want[f].reshape(got[f].shape)
        check(torch.equal(got[f], w), f"B1 {f} in the x + y call differs from its plain version")
        err = max(err, max_abs_err(torch, got[f], w))
    # each output row read once and written once, src read once for both leaves
    nbytes = 2 * cap * (8 + 4) + 4 * cap
    cats = {f: torch.cat([items[f], batch[f]]) for f in items}
    yard_a = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    yard_b = torch.empty_like(yard_a)
    ms = timer(lambda: ts_ops.tbs_step_apply(items, batch, src), reps)
    plain = timer(plain_xy, reps)
    lib = sum(timer(lambda c=c: torch.index_select(c, 0, src), reps) for c in cats.values())
    copy_ms = timer(lambda: yard_b.copy_(yard_a), reps)
    bound = nbytes / bw * 1e3
    per_leaf = rows["f32[.,2]"]["bound_ms"] + rows["f32[.]"]["bound_ms"]
    print(f"[2] B1 main tick x + y in one launch: kernel {ms:.4f} ms ({B1_BEFORE_MS} before, "
          f"a launch per leaf)  bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, src "
          f"once; the per-leaf bound summed {per_leaf:.4f})  plain {plain:.4f} ms  "
          f"index_select x + y {lib:.4f} ms  copy_ of {nbytes / 1e6:.1f} MB {copy_ms:.4f} ms "
          f"(yardstick); kernel = {ms / bound:.2f}x its bound, {nbytes / ms / 1e9:.2f} TB/s")
    b1 = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, err=err,
              copy_ms=copy_ms)
    del got, want, cats, yard_a, yard_b

    # B2 on the main path's x + y leaves in one call (one launch): on a
    # uniform mask, on a realized sample's prefix (materialize_view's mask on
    # the main path) and on a block-sparse mask of 8 shard prefixes (the
    # distributed global view's)
    from repro_torch.kernels.reservoir_compact.bench import bound_bytes, case_mask

    items = {"x": torch.randn((cap, 2), generator=g, device="cuda"),
             "y": torch.randn((cap,), generator=g, device="cuda")}
    once = (2 * 12 * cap + cap) / bw * 1e3        # every row read, the mask once
    per_leaf = sum((2 * rb * cap + cap) / bw * 1e3 for rb in (8, 4))
    b2 = None
    for kind in ("uniform", "prefix", "block"):
        mask = (torch.rand((cap,), generator=g, device="cuda") < 0.6 if kind == "uniform"
                else case_mask(kind, cap, g))
        n0 = rc_ops.reservoir_compact.launches
        got, cnt = rc_ops.reservoir_compact(items, mask)
        torch.cuda.synchronize()
        check(rc_ops.reservoir_compact.launches == n0 + 1, f"B2 x + y ({kind}) not in one launch")
        kept = int(mask.sum())
        check(cnt.dtype == torch.int32 and int(cnt) == kept, f"B2 count differs ({kind})")
        err = 0.0
        for f in items:
            want, wcnt = rc_ref.compact_ref(items[f].reshape(cap, -1), mask)
            want = want.reshape(items[f].shape)
            check(int(wcnt) == kept and torch.equal(got[f], want),
                  f"B2 {f} ({kind}) differs from compact_ref")
            check(torch.equal(got[f][:kept], items[f][mask]), f"B2 {f} ({kind}) != items[mask]")
            err = max(err, max_abs_err(torch, got[f], want))
        ms = timer(lambda: rc_ops.reservoir_compact(items, mask), reps)
        plain = timer(lambda: [rc_ref.compact_ref(items[f].reshape(cap, -1), mask)
                               for f in items], reps)
        lib = timer(lambda: (items["x"][mask], items["y"][mask]), reps)
        nbytes = bound_bytes([8, 4], mask)
        bound = nbytes / bw * 1e3
        yard_a = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
        yard_b = torch.empty_like(yard_a)
        copy_ms = timer(lambda: yard_b.copy_(yard_a), reps)
        del yard_a, yard_b
        print(f"[2] B2 reservoir_compact x + y in one launch, {kind} mask ({kept} of {cap} "
              f"kept): exact vs compact_ref and items[mask]  kernel {ms:.4f} ms "
              f"({B2_BEFORE_MS} before, a launch per leaf)  bound {bound:.4f} ms "
              f"({nbytes / 1e6:.2f} MB: mask once, sectors of kept rows, whole output; "
              f"every row read {once:.4f}, the per-leaf bounds summed {per_leaf:.4f})  "
              f"plain {plain:.4f} ms  items[mask] x + y {lib:.4f} ms (packed rows only, "
              f"with its host sync)  copy_ of the bound's bytes {copy_ms:.4f} ms "
              f"(yardstick); kernel = {ms / bound:.2f}x its bound")
        if kind == "uniform":
            b2 = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, err=err,
                      copy_ms=copy_ms,
                      bound_counts="the mask once; per leaf the 32-byte sectors that hold a "
                                   "kept row, and the whole output")
    del items, got

    # H1 on the main path's maps (L = cap, D = bcap words: the forest route)
    # at 4,096 to 65,536 trips, and at the bank's shape (the rows route)
    D = bcap
    sd = sd_ops.swap_delete
    n0, f0 = sd.launches, sd.forest_launches
    bits = torch.randint(0, 2**32, (D + 2,), generator=g, device="cuda")
    k = torch.full((), cap - 1, dtype=torch.int64, device="cuda")
    h1, shapes = {}, {}
    for trips_n in (4096, 32768, 65536):
        trips = torch.full((), trips_n, dtype=torch.int64, device="cuda")
        got = sd(cap, trips, k, bits, D)
        ms = timer(lambda: sd(cap, trips, k, bits, D), reps)
        bound = (8 * cap + 8 * trips_n + 16) / bw * 1e3
        if trips_n == 4096:
            t0 = time.perf_counter()
            want = sd_ref.swap_delete_ref(cap, trips, k, bits, D)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t0) * 1e3   # one call: one step at a time
            h1 = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound,
                      err=max_abs_err(torch, got, want))
            held = f"swap_delete_ref (plain {plain:.1f} ms, one call)"
        else:
            want = sd_ref.swap_delete_forest_ref(cap, trips, k, bits, D)
            held = "swap_delete_forest_ref"
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"H1 at {trips_n} trips differs from {held}")
        shapes[f"L={cap} D={D} trips={trips_n}"] = dict(ms=ms, bound_ms=bound)
        print(f"[2] H1 swap_delete L={cap} trips={trips_n:6d} ({sd_ops.route(cap, D)}) "
              f"kernel {ms:.4f} ms  bound {bound:.4f} ms  equal to {held}")
    ratio = shapes[f"L={cap} D={D} trips=65536"]["ms"] / h1["ms"]
    print(f"[2] H1 at 65,536 trips / at 4,096 trips: {ratio:.2f}x")
    # the bank's tick maps: b routed rows at L = cap (stage 1) and cap + bcap
    # (overshoot), D = bcap words; ~17,300 live rows with up to D trips each
    T, Db = B_BANK, min(BCAP_BANK, N_BANK + 1)
    live = torch.arange(T, device="cuda") < 17_344
    for L in (N_BANK + 1, N_BANK + 1 + BCAP_BANK):
        kb = torch.randint(0, L + 1, (T,), generator=g, device="cuda")
        tb = torch.where(live, (torch.rand((T,), generator=g, device="cuda")
                                * (torch.clamp(kb, max=Db) + 1)).long(), 0)
        bb = torch.randint(0, 2**32, (T, Db + 2), generator=g, device="cuda")
        got = sd(L, tb, kb, bb, Db)
        ms = timer(lambda: sd(L, tb, kb, bb, Db), reps)
        bound = (T * (8 * L + 16) + 8 * int(tb.sum())) / bw * 1e3
        for fn in (sd_ref.swap_delete_ref, sd_ref.swap_delete_forest_ref):
            check(torch.equal(got, fn(L, tb, kb, bb, Db)),
                  f"H1 at the bank's L = {L} differs from {fn.__name__}")
        shapes[f"bank T={T} L={L} D={Db}"] = dict(ms=ms, bound_ms=bound)
        print(f"[2] H1 swap_delete bank T={T} L={L} D={Db} ({sd_ops.route(L, Db)}) "
              f"kernel {ms:.4f} ms  bound {bound:.4f} ms  equal to both plain versions")
    h1["shapes"] = shapes
    nf, nall = sd.forest_launches - f0, sd.launches - n0
    print(f"[2] H1 launches by route in this phase: forest {nf}, rows {nall - nf}")
    return {"tbs_step_apply": b1, "reservoir_compact": b2, "swap_delete": h1}


def _branches(W_prev, W_new, C_new, n):
    """Alg. 2 branch of each tick from the host trace."""
    out = []
    for wp, wn, cn in zip(W_prev, W_new, C_new):
        if wp < n:
            out.append("overshoot" if cn == n else "insert")
        else:
            out.append("replace" if wn >= n else "undershoot")
    return out


def _drive_ticks(torch, sampler, model, key, batches, bcounts):
    """The loop's tick body driven tick by tick, recording W_t and C_t."""
    from repro_torch.manage import item_proto, make_manage_step

    tick = make_manage_step(sampler, model, retrain_every=RETRAIN_EVERY)
    state, params = sampler.init(item_proto(batches)), model.init()
    Ws, Cs = [], []
    for t in range(bcounts.shape[0]):
        state, params, _ = tick(key, t, state, params,
                                {f: v[t] for f, v in batches.items()}, bcounts[t])
        Ws.append(state.total_weight)
        Cs.append(state.lat.weight)
    return state, torch.stack(Ws).cpu().numpy(), torch.stack(Cs).cpu().numpy()


def _check_w(np, Ws, bcounts, lam):
    d = np.float32(math.exp(-lam))
    w = np.float32(0.0)
    for t, b in enumerate(bcounts):
        w = np.float32(d * w) + np.float32(b)
        check(Ws[t] == w, f"tick {t}: W {Ws[t]!r} != d*W + B = {w!r}")


def _main_stream(torch, tag: str):
    """The main cell's stream: LinRegStream(seed=0), 24 ticks of 65,536 items
    then 24 of 8,192 (bcap 65,536), a single shift over ticks 30-39."""
    from repro_torch.data.streams import LinRegStream, mode_schedule
    from repro_torch.manage import materialize_stream

    T = 48
    sizes = [BCAP_MAIN if t < 24 else 8192 for t in range(T)]
    t0 = time.perf_counter()
    batches, bcounts = materialize_stream(
        LinRegStream(seed=0), T, batch_size=lambda t: sizes[t], bcap=BCAP_MAIN,
        mode=lambda t: mode_schedule("single", t, start=30, stop=40))
    torch.cuda.synchronize()
    print(f"{tag} stream: {T} ticks, {sum(sizes)} items, "
          f"{sum(v.numel() * v.element_size() for v in batches.values()) / 1e6:.1f} MB "
          f"on the card, made in {time.perf_counter() - t0:.2f} s")
    return batches, bcounts, sizes


def phase_main(torch, np, kernels, timer, bw, reps):
    """Phase 3: the main path at cap = 2^20 on the card."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler, materialize_view
    from repro_torch.kernels.swap_delete import ops as sd_ops
    from repro_torch.manage import make_model, make_run_loop

    batches, bcounts, sizes = _main_stream(torch, "[3]")
    T = len(sizes)
    sampler = make_sampler("rtbs", n=N_MAIN, lam=LAM)
    model = make_model("linreg", dim=2)
    key = prng.key(0)
    run = make_run_loop(sampler, model, retrain_every=RETRAIN_EVERY)

    # warm-up on a short prefix (allocator, kernel loading), then the timed run
    run(key, {f: v[:RETRAIN_EVERY] for f, v in batches.items()}, bcounts[:RETRAIN_EVERY])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, params, trace = run(key, batches, bcounts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    view = materialize_view(sampler.extract(prng.key(99), state))
    torch.cuda.synchronize()
    launches = kernels.launches()
    print(f"[3] main path: {T} ticks in {wall:.3f} s = {T / wall:.2f} ticks/s; "
          f"launches {launches}")
    check(launches["tbs_step_apply"] == T, "B1 not launched once per tick")
    check(launches["swap_delete"] >= T, "H1 not launched on every tick")
    check(sd_ops.swap_delete.forest_launches == launches["swap_delete"],
          "H1 left its forest route on the main path")
    check(launches["reservoir_compact"] == 1,
          "B2 not launched once (x + y in one launch) by materialize_view")
    print(f"[3] H1 launches by route: forest {sd_ops.swap_delete.forest_launches}, "
          f"rows {launches['swap_delete'] - sd_ops.swap_delete.forest_launches}")

    sizes_t = trace["size"].cpu().numpy()
    metrics = trace["metric"].cpu().numpy()
    check(sizes_t.shape == (T,) and (sizes_t <= N_MAIN).all(), "size > n")
    check(np.isfinite(metrics).all(), "non-finite metric")
    check(torch.isfinite(params).all().item(), "non-finite params")

    # the same tick body by hand, for the per-tick W/C trace
    st2, Ws, Cs = _drive_ticks(torch, sampler, model, key, batches, bcounts)
    for a, b in ((st2.lat.items["x"], state.lat.items["x"]),
                 (st2.lat.items["y"], state.lat.items["y"]),
                 (st2.total_weight, state.total_weight)):
        check(torch.equal(a, b), "manage_step by hand != make_run_loop")
    _check_w(np, Ws, sizes, LAM)
    br = _branches(np.concatenate([[0.0], Ws[:-1]]), Ws, Cs, np.float32(N_MAIN))
    counts = {b: br.count(b) for b in ("insert", "overshoot", "replace", "undershoot")}
    print(f"[3] branches per tick: {counts}; sequence {''.join(b[0] for b in br)}")
    for b, c in counts.items():
        check(c > 0, f"branch {b} never taken")
    print(f"[3] W_t = d W_(t-1) + B_t exact on all {T} ticks (f32 on the host); "
          f"final C {float(state.lat.weight):.1f} W {float(state.total_weight):.1f}; "
          f"metric first/last {metrics[0]:.4f}/{metrics[-1]:.4f}")

    # B2 on the final state, checked against the mask
    mask, size = sampler.extract(prng.key(99), state).mask, view.size
    check(int(view.mask.sum()) == int(size) == int(mask.sum()), "view size")
    for f in ("x", "y"):
        check(torch.equal(view.items[f][: int(size)], state.lat.items[f][mask]),
              f"materialized {f} != items[mask]")
        check(not view.items[f][int(size):].any(), f"materialized {f} tail not zero")
    print(f"[3] materialize_view: {int(size)} rows packed, equal to items[mask]")

    # one non-retrain tick with every host sync an error
    from repro_torch.manage import make_manage_step

    tick = make_manage_step(sampler, model, retrain_every=RETRAIN_EVERY)
    t_free = T  # (T + 1) % 4 != 0: no retrain on this tick
    check((t_free + 1) % RETRAIN_EVERY != 0, "sync-check tick must not retrain")
    b_t = {f: v[T - 1] for f, v in batches.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tick(key, t_free, state, params, b_t, bcounts[T - 1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(out[0].lat.weight.item() <= N_MAIN, "sync-check tick")
    print("[3] one non-retrain tick ran under set_sync_debug_mode('error'): no host sync")

    b1_tick_ms = _b1_on_a_tick_map(torch, timer, bw, state, b_t, bcounts[T - 1], reps)

    # profile one retrain tick
    prof_t = 4 * RETRAIN_EVERY - 1
    s_in = st2
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tick(key, prof_t, s_in, params, b_t, bcounts[T - 1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return dict(ticks_per_s=T / wall, launches=launches, b1_tick_ms=b1_tick_ms,
                profile=_breakdown(torch, prof, wall_ms))


def _b1_on_a_tick_map(torch, timer, bw, state, b_t, bcount, reps) -> float:
    """B1 on the map of a real main tick (the next tick's, composed from the
    run's final state), x + y in one launch, against its plain version."""
    from repro_torch.core import prng, rtbs
    from repro_torch.kernels.tbs_step import ops as ts_ops, ref as ts_ref

    items = state.lat.items
    batch = {f: b_t[f] for f in items}
    cap, bcap = state.lat.cap, batch["y"].shape[0]
    decay = torch.full((), math.exp(-LAM), dtype=torch.float32, device="cuda")
    src, _, _ = rtbs.tick_map(rtbs.draw_tick(prng.key(1234), cap=cap, bcap=bcap, device="cuda"),
                              state.lat.nfull, state.lat.weight, state.total_weight, bcount,
                              decay, cap=cap, bcap=bcap, n=N_MAIN)
    got = ts_ops.tbs_step_apply(items, batch, src)
    for f in items:
        want = ts_ref.apply_ref(items[f].reshape(1, cap, -1), batch[f].reshape(1, bcap, -1),
                                src[None]).reshape(got[f].shape)
        check(torch.equal(got[f], want), f"B1 {f} on a tick map differs from its plain version")
    kept = int((src == torch.arange(cap, device="cuda")).sum())
    ms = timer(lambda: ts_ops.tbs_step_apply(items, batch, src), reps)
    bound = (2 * cap * 12 + 4 * cap) / bw * 1e3
    print(f"[3] B1 on a main tick's map ({kept} of {cap} rows kept in place), x + y in one "
          f"launch: kernel {ms:.4f} ms, equal to its plain version; bound {bound:.4f} ms; "
          f"kernel = {ms / bound:.2f}x its bound")
    return ms


# every kernel H1's two routes launch (csrc/swap_delete.cu)
H1_KERNELS = ("swap_delete_init_kernel", "swap_delete_last_kernel",
              "swap_delete_map_kernel", "swap_delete_rows_kernel")
_SCOPES = ("manage.eval", "manage.sampler_step", "rtbs.tick_map", "rtbs.payload",
           "manage.retrain", "manage.size")
_BANK_SCOPES = ("manage.eval", "manage.sampler_step", "bank.decay", "bank.route",
                "bank.tick_map", "bank.payload", "manage.retrain", "manage.size")


def _breakdown(torch, prof, wall_ms: float, tag: str = "[3]", scopes=_SCOPES,
               named=(("B1 kernel", "tbs_step_apply_kernel"),
                      ("H1 kernels", H1_KERNELS)),
               what: str = "retrain tick") -> dict:
    """Device time of one profiled tick (or serving step): kernel time summed
    over the device's kernel events, each scope's share (and its kernel
    count, ``"<scope> kernels"``), the hand-written kernels by name, and the
    device's idle share of the step's wall time. A scope's share is the time
    of the kernels that start inside its ranges on the device (the
    profiler's device-side annotation of each ``record_function``,
    ctypes-launched kernels included). Those ranges hold a scope's kernels
    but not those of a scope nested in it, so the shares split the device
    time. (Summing the CPU ranges' ``device_time_total`` instead counted some
    kernels under several ranges: the Mamba2 prefill's scopes summed to 3.1x
    its device time.) The events are read raw from the profiler's kineto
    results with numpy: a retrain tick of phase 13 holds ~170,000 kernels,
    and building ``prof.events()`` for them took 130 s of host time (NVIDIA
    H100 80GB HBM3 at 700 W)."""
    import numpy as np
    from torch.autograd import DeviceType

    starts, durs, names = [], [], []
    spans = {s: [] for s in scopes}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if e.is_user_annotation():
            if e.name() in spans:
                spans[e.name()].append((e.start_ns(), e.end_ns()))
        else:
            starts.append(e.start_ns())
            durs.append(e.duration_ns())
            names.append(e.name())
    starts, durs = np.asarray(starts, np.int64), np.asarray(durs, np.float64)
    busy = float(durs.sum()) / 1e6
    res = {"wall_ms": wall_ms, "device_ms": busy, "kernels": len(names)}
    for label, sub in named:
        subs = (sub,) if isinstance(sub, str) else sub
        res[label] = float(sum(d for n, d in zip(names, durs)
                               if any(x in n for x in subs))) / 1e6
    for name in scopes:
        sp = np.asarray(sorted(spans[name]), np.int64).reshape(-1, 2)
        inside = np.zeros(len(starts), bool)
        if len(sp):
            i = np.searchsorted(sp[:, 0], starts, side="right") - 1
            inside = (i >= 0) & (starts < sp[np.clip(i, 0, None), 1])
        res[name] = float(durs[inside].sum()) / 1e6
        res[f"{name} kernels"] = int(inside.sum())
    print(f"{tag} profiled {what}: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms in {len(names)} kernels, idle "
          f"{100 * (1 - busy / wall_ms):.1f} % of the {what}")
    for k in tuple(label for label, _ in named) + tuple(scopes):
        v = res.get(k, 0.0)
        print(f"{tag}   {k:22s} {v:9.3f} ms  {100 * v / max(busy, 1e-9):5.1f} % "
              f"of device time")
    by_name = {}
    for n, d in zip(names, durs):
        by_name[n] = by_name.get(n, 0.0) + d / 1e6
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"{tag}   top kernel: {name[:70]:70s} {v:8.3f} ms")
    return res


def phase_cpu_parity(torch, np):
    """Phase 4: the same path small, on the card and on the CPU."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler
    from repro_torch.data.streams import LinRegStream
    from repro_torch.manage import make_model, make_run_loop, materialize_stream

    n, bcap, T = 4095, 256, 48
    out = {}
    for dev in ("cuda", "cpu"):
        batches, bcounts = materialize_stream(
            LinRegStream(seed=1), T, batch_size=lambda t: bcap if t < 24 else 32,
            bcap=bcap, device=dev)
        run = make_run_loop(make_sampler("rtbs", n=n, lam=LAM, device=dev),
                            make_model("linreg", dim=2, device=dev),
                            retrain_every=RETRAIN_EVERY)
        state, params, trace = run(prng.key(7), batches, bcounts)
        out[dev] = (state, params, trace)
    (sg, pg, tg), (sc, pc, tc) = out["cuda"], out["cpu"]
    for f in ("x", "y"):
        check(torch.equal(sg.lat.items[f].cpu(), sc.lat.items[f]), f"items[{f}] card != CPU")
    check(torch.equal(sg.lat.nfull.cpu(), sc.lat.nfull), "nfull card != CPU")
    check(torch.equal(sg.lat.weight.cpu(), sc.lat.weight), "weight card != CPU")
    check(torch.equal(sg.total_weight.cpu(), sc.total_weight), "W card != CPU")
    check(torch.equal(tg["size"].cpu(), tc["size"]), "trace sizes card != CPU")
    check(torch.allclose(tg["metric"].cpu(), tc["metric"], rtol=1e-4, atol=1e-5),
          "metrics card vs CPU beyond rtol 1e-4")
    dm = float((tg["metric"].cpu() - tc["metric"]).abs().max())
    print(f"[4] cap 4096: card == CPU bit for bit (items, nfull, weight, W, sizes); "
          f"metrics max |diff| {dm:.3g} (rtol 1e-4: f32 sums in another order)")


def phase_nb(torch, np, kernels):
    """Phase 5: a wide payload (100-word counts) with naive_bayes."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler
    from repro_torch.data.streams import UsenetLikeStream
    from repro_torch.manage import make_model, make_run_loop, materialize_stream

    n, bcap, T, vocab = 65_535, 4096, 8, 100      # 8 ticks (16 before phase 21: time limit)
    t0 = time.perf_counter()
    batches, bcounts = materialize_stream(UsenetLikeStream(seed=0, vocab=vocab), T,
                                          batch_size=bcap)
    print(f"[5] usenet-like stream: {T} x {bcap} messages, vocab {vocab}, made in "
          f"{time.perf_counter() - t0:.2f} s")
    sampler = make_sampler("rtbs", n=n, lam=LAM)
    model = make_model("naive_bayes", vocab=vocab)
    run = make_run_loop(sampler, model, retrain_every=RETRAIN_EVERY)
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, params, trace = run(prng.key(3), batches, bcounts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    check(launches["tbs_step_apply"] == T, "B1 not once per tick")
    check(launches["swap_delete"] >= T, "H1 not launched")
    m = trace["metric"].cpu().numpy()
    check(np.isfinite(m).all(), "non-finite NB metric")
    check((trace["size"].cpu().numpy() <= n).all(), "size > n")
    st2, Ws, _ = _drive_ticks(torch, sampler, model, prng.key(3), batches, bcounts)
    _check_w(np, Ws, [bcap] * T, LAM)
    print(f"[5] naive_bayes: {T} ticks in {wall:.3f} s ({T / wall:.2f} ticks/s), "
          f"reservoir {state.lat.items['x'].numel() * 4 / 1e6:.1f} MB, launches "
          f"{launches}, error first/last {m[0]:.3f}/{m[-1]:.3f}, W exact")

# the keyed bank at the DESIGN.md Sec. 13 scale
K_BANK, N_BANK, B_BANK, BCAP_BANK, LAM_BANK, T_BANK, Q_BANK = 2**20, 64, 65_536, 32, 0.05, 32, 64


def _b3_bytes(torch, src, r, row_bytes, cap, bcap):
    """The least bytes B3's in-place function moves on one tick's operands,
    for leaves of the given row bytes updated together, counted on the
    device: each live row's ``touched``, ``starts`` and ``src`` entries once;
    per leaf, each distinct reservoir row that a written slot reads, each
    distinct batch row that a slot takes (its ``order`` entry once for all
    leaves), and each slot of ``ref.banked_write_mask``, written. A slot
    that keeps its own row moves nothing. Returns (bytes, slots written per
    leaf, of which batch rows taken, distinct batch rows)."""
    from repro_torch.kernels.tbs_step import ref as ts_ref

    b = src.shape[0]
    dev = src.device
    live = (torch.arange(b, device=dev) < r.ntouched).unsqueeze(-1)
    s = src.long()
    write = live & ts_ref.banked_write_mask(src, cap)
    take = write & (s >= cap)
    moved = write & ~take
    rd = torch.zeros((b, cap + 1), dtype=torch.bool, device=dev)
    rd.scatter_(1, torch.where(moved, s.clamp(0, cap - 1), cap), True)  # column cap: no read
    rb = torch.zeros((b, bcap + 1), dtype=torch.bool, device=dev)
    rb.scatter_(1, torch.where(take, (s - cap).clamp(0, bcap - 1), bcap), True)
    n_rd, n_pay = int(rd[:, :cap].sum()), int(rb[:, :bcap].sum())
    n_wr, n_take = int(write.sum()), int(take.sum())
    nt = min(int(r.ntouched), b)
    nbytes = (sum(B * (n_wr + n_rd + n_pay) for B in row_bytes) + 4 * n_pay
              + (4 * cap + 8) * nt + 4)
    return nbytes, n_wr, n_take, n_pay


def _b3_equal(torch, leaf, pleaf, src, r, bcap, what, tag="[6]"):
    """B3 on a copy of ``leaf`` against its plain version on another copy."""
    from repro_torch.kernels.tbs_step import ops as ts_ops, ref as ts_ref

    got, want = leaf.clone(), leaf.clone()
    n0 = ts_ops.tbs_step_apply_banked.launches
    ts_ops.tbs_step_apply_banked(got, pleaf, src, order=r.order, starts=r.starts,
                                 touched=r.touched, ntouched=r.ntouched, bcap=bcap)
    K, cap = leaf.shape[:2]
    ts_ref.banked_ref(want.view(K, cap, -1), pleaf.reshape(pleaf.shape[0], -1), src,
                      r.order, r.starts, r.touched, r.ntouched, bcap)
    torch.cuda.synchronize()
    check(ts_ops.tbs_step_apply_banked.launches == n0 + 1, f"B3 {what} not launched")
    check(torch.equal(got, want), f"B3 {what} differs from its plain version")
    print(f"{tag} (a) B3 {what}: equal to its plain version bit for bit")
    return max_abs_err(torch, got, want)


def phase_bank(torch, np, kernels, timer, bw, reps):
    """Phase 6: the keyed R-TBS bank and its manage loop at K = 2^20."""
    from repro_torch.bank import make_bank, route
    from repro_torch.bank.bank import _rtbs_tick_map
    from repro_torch.core import prng
    from repro_torch.data.streams import KeyedStream, LinRegStream
    from repro_torch.kernels.swap_delete import ops as sd_ops
    from repro_torch.kernels.tbs_step import ops as ts_ops, ref as ts_ref
    from repro_torch.manage import (make_bank_manage_step, make_bank_run_loop,
                                    make_model, materialize_stream)

    K, n, b, bcap, T, Q = K_BANK, N_BANK, B_BANK, BCAP_BANK, T_BANK, Q_BANK
    cap = n + 1
    t0 = time.perf_counter()
    stream = KeyedStream(LinRegStream(seed=0), num_keys=K, alpha=1.1, flip_every=50)
    batches, bcounts = materialize_stream(stream, T, batch_size=b,
                                          fields=("key", "x", "y"))
    torch.cuda.synchronize()
    print(f"[6] keyed stream: {T} ticks x {b} arrivals over K = {K} keys, made in "
          f"{time.perf_counter() - t0:.2f} s")
    bank = make_bank("rtbs", num_keys=K, n=n, lam=LAM_BANK, bcap=bcap)
    model = make_model("linreg", dim=2)
    key = prng.key(0)
    run = make_bank_run_loop(bank, model, retrain_every=RETRAIN_EVERY,
                             train_keys=range(Q))
    run(key, {f: v[:2] for f, v in batches.items()}, bcounts[:2])   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, params, trace = run(key, batches, bcounts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    items_mb = sum(v.numel() * v.element_size() for v in state.items.values()) / 1e6
    print(f"[6] bank loop: {T} ticks in {wall:.3f} s = {T / wall:.2f} ticks/s, "
          f"{T * b / wall:.0f} keyed items/s; bank items {items_mb:.1f} MB on the "
          f"card; launches {launches}")
    check(launches["tbs_step_apply_banked"] == T, "B3 not launched once per tick")
    check(launches["swap_delete"] >= T, "H1 not launched on every bank tick")
    check(sd_ops.swap_delete.forest_launches == 0,
          "H1 left its rows route on the bank path")
    sizes = trace["size"].cpu().numpy()
    metric = trace["metric"].cpu().numpy()
    check(sizes.shape == (T, Q) and (sizes <= n).all(), "bank size > n")
    check(np.isfinite(metric).all(), "non-finite bank metric")
    check(torch.isfinite(params).all().item(), "non-finite bank params")
    print(f"[6] sizes of the {Q} train keys at the end: min {sizes[-1].min()} max "
          f"{sizes[-1].max()}; metric first/last {metric[0]:.4f}/{metric[-1]:.4f}; "
          f"overflow per tick {trace['overflow'].cpu().numpy().tolist()[:4]}...")
    del state

    # (b) the tick body by hand: W_{t+1} = d_eff W_t + B_t and pending on the host
    tick = make_bank_manage_step(bank, model, retrain_every=RETRAIN_EVERY,
                                 train_keys=range(Q))
    st = bank.init({"x": torch.zeros(2, device="cuda"), "y": torch.zeros((), device="cuda")})
    p = model.init()
    d = np.float32(math.exp(-LAM_BANK))
    W = np.zeros(K, np.float32)
    pend = np.ones(K, np.float32)
    keys_h = batches["key"].cpu().numpy()
    nts = []
    for t in range(T):
        bt = {f: v[t] for f, v in batches.items()}
        st, p, _ = tick(key, t, st, p, bt, bcounts[t])
        pend = (pend * d).astype(np.float32)
        u, c = np.unique(keys_h[t, : int(bcounts[t])], return_counts=True)
        W[u] = (pend[u] * W[u]).astype(np.float32) + np.minimum(c, bcap).astype(np.float32)
        pend[u] = 1.0
        nts.append(len(u))
        check(np.array_equal(st.total_weight.cpu().numpy(), W), f"tick {t}: W column")
        check(np.array_equal(st.pending.cpu().numpy(), pend), f"tick {t}: pending column")
    check((st.nfull.cpu().numpy() <= n).all(), "nfull > n")
    print(f"[6] ntouched per tick: {nts}")
    print(f"[6] (b) W = d_eff W + B exact in f32 and pending = product of the d's "
          f"since the last touch, for all {K} keys on all {T} ticks")

    # (c) one non-retrain tick under set_sync_debug_mode("error")
    t_free = T
    check((t_free + 1) % RETRAIN_EVERY != 0, "sync-check tick must not retrain")
    bt = {f: v[T - 1] for f, v in batches.items()}
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st2, p2, _ = tick(key, t_free, st, p, bt, bcounts[T - 1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(kernels.launches()["tbs_step_apply_banked"] == 1, "sync-check tick: B3")
    print("[6] (c) one non-retrain bank tick ran under set_sync_debug_mode('error'): "
          "no host sync")

    # profile one retrain tick
    prof_t = 4 * RETRAIN_EVERY - 1
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st2, p2, _ = tick(key, prof_t, st2, p2, bt, bcounts[T - 1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    profile = _breakdown(torch, prof, wall_ms, "[6]", _BANK_SCOPES,
                         (("B3 kernel", "tbs_step_banked_kernel"),
                          ("H1 kernels", H1_KERNELS)))

    # (a) and B3's time at this shape, on one tick's real operands, made by
    # the bank's own tick up to its payload pass
    r, src, *_ = _rtbs_tick_map(prng.key(5), st2, bt["key"], bcounts[T - 1],
                                st2.pending * bank.base_rate(st2), n=n, bcap=bcap)
    payload = {"x": bt["x"], "y": bt["y"]}
    err = max(_b3_equal(torch, st2.items["x"], payload["x"], src, r, bcap,
                        "x f32[., 2] at K = 2^20"),
              _b3_equal(torch, st2.items["y"], payload["y"], src, r, bcap,
                        "y f32[.] at K = 2^20"))
    g = torch.Generator(device="cuda").manual_seed(6)
    leaf12 = torch.randn((K, cap, 3), generator=g, device="cuda")
    pay12 = torch.randn((b, 3), generator=g, device="cuda")
    err = max(err, _b3_equal(torch, leaf12, pay12, src, r, bcap,
                             "12-byte rows f32[., 3] at K = 2^20"))
    del leaf12
    K400 = 1 << 16
    keys400 = torch.randint(0, K400, (b,), generator=g, device="cuda")
    r400 = route(keys400, b, num_keys=K400, bcap=bcap)
    src400 = torch.randint(-3, cap + bcap + 3, (b, cap), generator=g, device="cuda",
                           dtype=torch.int32)
    leaf400 = torch.randn((K400, cap, 100), generator=g, device="cuda")
    pay400 = torch.randn((b, 100), generator=g, device="cuda")
    err = max(err, _b3_equal(torch, leaf400, pay400, src400, r400, bcap,
                             "400-byte rows f32[., 100] at K = 2^16"))
    del leaf400, pay400

    nt = int(r.ntouched)
    row_bytes = [leaf[0, 0].numel() * leaf.element_size() for leaf in st2.items.values()]
    nbytes, n_wr, n_take, npay = _b3_bytes(torch, src, r, row_bytes, cap, bcap)
    bound = nbytes / bw * 1e3
    # what this design moves: each live row's touched and starts entries
    # (the routing's int64) and its src row once for all leaves, an order
    # entry per slot that takes a batch row, and per leaf a read and a write
    # for each written slot
    design = (nt * (4 * cap + 16) + 8 + 8 * n_take
              + sum(2 * B * n_wr for B in row_bytes))
    items = st2.items
    # x + y in one call, as the tick makes it, against the plain version
    got, want = ({f: v.clone() for f, v in items.items()} for _ in range(2))
    n0 = ts_ops.tbs_step_apply_banked.launches
    ts_ops.tbs_step_apply_banked(got, payload, src, order=r.order, starts=r.starts,
                                 touched=r.touched, ntouched=r.ntouched, bcap=bcap)
    for f, leaf in want.items():
        ts_ref.banked_ref(leaf.view(K, cap, -1), payload[f].reshape(b, -1), src,
                          r.order, r.starts, r.touched, r.ntouched, bcap)
    torch.cuda.synchronize()
    check(ts_ops.tbs_step_apply_banked.launches == n0 + 1, "B3 x + y not in one launch")
    for f in got:
        check(torch.equal(got[f], want[f]), f"B3 {f} in the x + y call differs from "
              f"its plain version")
    print("[6] (a) B3 x + y in one launch: equal to its plain version bit for bit")
    del got, want

    def fused():
        ts_ops.tbs_step_apply_banked(items, payload, src, order=r.order, starts=r.starts,
                                     touched=r.touched, ntouched=r.ntouched, bcap=bcap)

    def plain():
        for f in ("x", "y"):
            leaf = items[f]
            ts_ref.banked_ref(leaf.view(K, cap, -1), payload[f].reshape(b, -1), src,
                              r.order, r.starts, r.touched, r.ntouched, bcap)

    tt = r.touched[:nt]
    sidx = (r.starts[:nt, None] + torch.arange(bcap, device="cuda")).clamp(0, b - 1)
    rows = r.order[sidx]

    def unfused():
        for f in ("x", "y"):
            leaf = items[f]
            items_t = torch.index_select(leaf, 0, tt)
            sub = payload[f][rows]
            out = ts_ops.tbs_step_apply(items_t, sub, src[:nt])
            leaf.index_copy_(0, tt, out)

    check(nt <= 65_535, "unfused yardstick needs ntouched <= 65,535 (B1's grid)")
    ms = timer(fused, reps)
    plain_ms = timer(plain, max(3, reps // 4))
    unf_ms = timer(unfused, reps)
    print(f"[6] B3 at this shape (ntouched {nt}, {n_wr} of {nt * cap} slots "
          f"written per leaf, {n_take} of them batch rows from {npay} distinct, x + y "
          f"leaves in one launch): kernel {ms:.4f} ms ({B3_BEFORE_MS} before, two "
          f"launches, one a leaf)  plain {plain_ms:.4f} ms  unfused index_select -> "
          f"B1 -> index_copy_ {unf_ms:.4f} ms  bound {bound:.4f} ms ({nbytes / 1e6:.3f} "
          f"MB that the function must move); this design moves {design / 1e6:.3f} MB "
          f"= {design / bw * 1e3:.4f} ms at the bound's rate; kernel = "
          f"{ms / bound:.2f}x its bound")
    return dict(ticks_per_s=T / wall, items_per_s=T * b / wall, launches=launches,
                profile=profile,
                b3=dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                        err=err, unfused_ms=unf_ms))


def phase_bank_parity(torch, np):
    """Phase 6 (d): the bank loop at K = 4096, cap 65, card against CPU."""
    from repro_torch.bank import make_bank
    from repro_torch.core import prng
    from repro_torch.data.streams import KeyedStream, LinRegStream
    from repro_torch.manage import make_bank_run_loop, make_model, materialize_stream

    out = {}
    for dev in ("cuda", "cpu"):
        batches, bcounts = materialize_stream(
            KeyedStream(LinRegStream(seed=1), num_keys=4096, alpha=1.1, flip_every=50),
            8, batch_size=2048, fields=("key", "x", "y"), device=dev)
        run = make_bank_run_loop(
            make_bank("rtbs", num_keys=4096, n=N_BANK, lam=LAM_BANK, bcap=BCAP_BANK,
                      device=dev),
            make_model("linreg", dim=2, device=dev), retrain_every=RETRAIN_EVERY,
            train_keys=range(Q_BANK))
        out[dev] = run(prng.key(3), batches, bcounts)
    (sg, pg, tg), (sc, pc, tc) = out["cuda"], out["cpu"]
    for f in ("x", "y"):
        check(torch.equal(sg.items[f].cpu(), sc.items[f]), f"bank items[{f}] card != CPU")
    for f in ("nfull", "weight", "total_weight", "pending", "overflow"):
        check(torch.equal(getattr(sg, f).cpu(), getattr(sc, f)), f"bank {f} card != CPU")
    for f in ("size", "overflow"):
        check(torch.equal(tg[f].cpu(), tc[f]), f"bank trace {f} card != CPU")
    check(torch.allclose(tg["metric"].cpu(), tc["metric"], rtol=1e-4, atol=1e-5),
          "bank metrics card vs CPU beyond rtol 1e-4")
    dm = float((tg["metric"].cpu() - tc["metric"]).abs().max())
    print(f"[6] (d) K = 4096, cap 65, 8 ticks: card == CPU bit for bit (items, nfull, "
          f"weight, W, pending, overflow, sizes); metrics max |diff| {dm:.3g}")


# the dense LM serving cell: stablelm_12b at full width and depth
SERVE_PROMPTS, SERVE_LEN, SERVE_GEN = 8, 2048, 32
_LM_SCOPES = ("lm.embed", "lm.norm", "lm.qkv", "lm.rope", "lm.attn", "lm.attn_out",
              "lm.mlp", "lm.logits")
# card vs CPU, teacher forcing: logits of f32 sums over d = 5,120 and
# d_ff = 13,824 taken in other orders (cuBLAS vs the CPU's BLAS, B4 vs its
# plain version, one token vs the whole sequence), through two layers
LM_F32_ATOL = 1e-3


def _pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep, positions counted from 0 in both."""
    total = 0
    for s in range(S):
        hi = min(s, T - 1) if causal else T - 1
        lo = max(0, s - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def _b4_bound_ms(q, k, causal, window, bw):
    """B4's least time: the larger of its FLOPs (QK^T and PV over the kept
    pairs) at the card's peak for the inputs' type and its bytes (q, k, v
    read once, o written once) at the memory's rate. Returns (ms, by, flops,
    bytes)."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    flops = 4 * hd * B * H * _pairs(S, T, causal, window)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    f_ms = flops / PEAK[str(q.dtype).split(".")[1]] * 1e3
    b_ms = nbytes / bw * 1e3
    return max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes"), flops, nbytes


# bf16 B4 against attention_ref in f32 on the same bf16 inputs: the largest
# |o - want| / |want| over the rows (b, s, h) of hd values. Rounding p and o
# to bf16 (each off by at most 2^-8 of itself) leaves about 3e-3 at hd >= 64
# and up to 6.7e-3 at hd 8, whose rows average only 8 values (NVIDIA H100,
# phase 7 (b)); a fault that moves the late rows of a long sequence by 0.01,
# a quarter of their typical |o|, gives about 0.25.
B4_BF16_ROW_REL = 8e-3


def _row_rel_err(torch, got, want) -> float:
    d = (got.double() - want.double()).norm(dim=-1)
    return float((d / want.double().norm(dim=-1).clamp_min(1e-30)).max())


def _b4_equal(torch, B, S, H, KV, hd, dtype, causal, window, atol, g, T=None,
              fused=False, tag="[7]"):
    """B4 against its plain version on the card, with T keys (default S);
    ``fused``: q, k and v as views of one [B, S, (H + 2 KV) hd] projection.
    Checks the route (bf16 on the tensor cores, f32 on the CUDA cores) and,
    for bf16, each row against the f32 reference (B4_BF16_ROW_REL); returns
    max |diff| to the plain version."""
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

    T = S if T is None else T
    if fused:
        qkv = torch.randn((B, S, (H + 2 * KV) * hd), generator=g, device="cuda").to(dtype)
        q = qkv[..., :H * hd].reshape(B, S, H, hd)
        k = qkv[..., H * hd:(H + KV) * hd].reshape(B, S, KV, hd)
        v = qkv[..., (H + KV) * hd:].reshape(B, S, KV, hd)
    else:
        q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, T, KV, hd), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, T, KV, hd), generator=g, device="cuda").to(dtype)
    n0 = fa_ops.flash_attention.launches
    t0 = fa_ops.flash_attention.tensor_core_launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = fa_ref.attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=window)
    torch.cuda.synchronize()
    check(fa_ops.flash_attention.launches == n0 + 1, "B4 not launched")
    tc = fa_ops.flash_attention.tensor_core_launches - t0
    check(tc == (dtype == torch.bfloat16), f"B4 {dtype} went to the wrong route")
    check(got.dtype == dtype and got.shape == q.shape, "B4 output dtype/shape")
    err = max_abs_err(torch, got, want)
    name = str(dtype).split(".")[1]
    what = (f"[B, S, T, H, KV, hd] = [{B}, {S}, {T}, {H}, {KV}, {hd}] {name} "
            f"causal={causal} window={window}{' fused views' if fused else ''}")
    check(err <= atol, f"B4 {what}: |diff| {err} > {atol}")
    rel = ""
    if dtype == torch.bfloat16:
        want32 = fa_ref.attention_ref(*(x.float() for x in (q, k, v)), causal=causal,
                                      window=window)
        rerr = _row_rel_err(torch, got, want32)
        del want32
        check(rerr <= B4_BF16_ROW_REL, f"B4 {what}: a row is {rerr} of its norm off the "
                                       f"f32 reference, > {B4_BF16_ROW_REL}")
        rel = f"; rows vs f32 reference {rerr:.3g} of their norm <= {B4_BF16_ROW_REL}"
    print(f"{tag} (b) B4 {what} ({'tensor' if tc else 'CUDA'} cores): max |diff| "
          f"{err:.3g} <= {atol}{rel}")
    return err


def phase_serve(torch, np, kernels, timer, bw):
    """Phase 7: batched serving of stablelm_12b at full size on the card."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch import convert
    from repro_torch.config import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import zoo

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("stablelm_12b"), attention_impl="pallas",
                              param_dtype="bfloat16")
    api = zoo.build(cfg)
    t0 = time.perf_counter()
    params = api.init_params(0)
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(params))
    print(f"[7] stablelm_12b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}; weights {w_bytes / 1e9:.3f} GB "
          f"bf16, made on the card in {time.perf_counter() - t0:.2f} s")

    # (a) the serve path: a short warm-up (cuBLAS handles, allocator), then
    # the measured run through serve_batch, the entry point's own body
    dev_gen = torch.Generator(device="cuda").manual_seed(1)
    serve_batch(api, params, zoo.make_demo_batch(cfg, dev_gen, SERVE_PROMPTS, 64), 2)
    batch = zoo.make_demo_batch(cfg, dev_gen, SERVE_PROMPTS, SERVE_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = serve_batch(api, params, batch, SERVE_GEN)
    launches = kernels.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pre_b4, dec_b4 = (res.prefill_launches["flash_attention"],
                      res.decode_launches["flash_attention"])
    ntok = SERVE_PROMPTS * SERVE_LEN
    print(f"[7] (a) serve {SERVE_PROMPTS} x {SERVE_LEN} prompts, {SERVE_GEN} generated: "
          f"prefill {res.prefill_s:.3f} s = {ntok / res.prefill_s:.0f} prompt tokens/s; "
          f"decode {res.decode_s:.3f} s = {SERVE_GEN * SERVE_PROMPTS / res.decode_s:.1f} "
          f"tokens/s ({1e3 * res.decode_s / SERVE_GEN:.2f} ms a step); peak memory "
          f"{peak_gb:.2f} GB")
    tc_b4 = fa_ops.flash_attention.tensor_core_launches
    print(f"[7] (a) B4 launches: prefill {pre_b4}, decode {dec_b4}, on the tensor-core "
          f"route {tc_b4}; all {launches}")
    check(pre_b4 == cfg.num_layers, f"B4 launched {pre_b4} times in the prefill, "
                                     f"not once per layer ({cfg.num_layers})")
    check(dec_b4 == 0, f"B4 launched {dec_b4} times in decode")
    check(tc_b4 == pre_b4, f"{pre_b4 - tc_b4} of the prefill's B4 launches missed the "
                           f"tensor-core route")
    check(launches["flash_attention"] == cfg.num_layers, "B4 launches of the run")
    toks = res.tokens
    check(toks.shape == (SERVE_PROMPTS, SERVE_GEN + 1), f"tokens shape {toks.shape}")
    check(((toks >= 0) & (toks < cfg.vocab_size)).all(), "token outside the vocabulary")
    print(f"[7] (a) first sequence: {toks[0].tolist()}")

    # (e) profile one prefill and one decode step by scope
    max_len = SERVE_LEN + SERVE_GEN + 1
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    named = (("B4 kernel", "flash_attention_tc_kernel"),)
    with torch.no_grad():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, caches = api.prefill(params, batch, max_len)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        pre = _breakdown(torch, prof, wall, "[7]", _LM_SCOPES, named, what="prefill")
        tok = torch.argmax(logits[:, :, : cfg.vocab_size], dim=-1)
        check(torch.isfinite(logits.float()).all().item(), "non-finite prefill logits")
        api.decode_step(params, caches, tok)          # warm the decode shapes
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, caches = api.decode_step(params, caches, tok)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dec = _breakdown(torch, prof, wall, "[7]", _LM_SCOPES, named, what="decode step")
        check(torch.isfinite(logits.float()).all().item(), "non-finite decode logits")
    check(pre["B4 kernel"] > 0, "the profiled prefill shows no B4 tensor-core kernel")
    cache_bytes = sum(2 * c.k[:, : c.length].numel() * c.k.element_size() for c in caches)
    del caches, logits
    print(f"[7] (e) B4 is {100 * pre['B4 kernel'] / pre['device_ms']:.1f} % of prefill "
          f"device time; the decode step's device is idle "
          f"{100 * (1 - dec['device_ms'] / dec['wall_ms']):.1f} % of it")
    print(f"[7] (e) decode step {1e3 * res.decode_s / SERVE_GEN:.2f} ms unprofiled; its "
          f"byte bound {w_bytes / bw * 1e3:.2f} ms for the {w_bytes / 1e9:.2f} GB of "
          f"weights ({(w_bytes + cache_bytes) / bw * 1e3:.2f} ms with the "
          f"{cache_bytes / 1e9:.2f} GB of filled cache) = "
          f"{SERVE_PROMPTS / (w_bytes / bw):.0f} tokens/s at {SERVE_PROMPTS} sequences")

    # (b) B4 against its plain version, and (e) its time at the prefill's shape
    g = torch.Generator(device="cuda").manual_seed(7)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bf = torch.bfloat16
    errs = [_b4_equal(torch, SERVE_PROMPTS, SERVE_LEN, H, KV, hd, bf, True, 0, 2e-2, g),
            # the tensor-core kernel: every head-dim layout, both masks, MQA /
            # GQA 4 / MHA, ragged, one-row and S != T lengths, fused views;
            # the ring wraps many times at S 2,048 under each mask
            _b4_equal(torch, 1, 2048, 8, 2, 160, bf, True, 100, 2e-2, g),
            _b4_equal(torch, 2, 65, 4, 1, 8, bf, True, 0, 2e-2, g),
            _b4_equal(torch, 1, 77, 8, 2, 24, bf, False, 0, 2e-2, g),
            _b4_equal(torch, 2, 256, 4, 4, 64, bf, True, 64, 2e-2, g),
            _b4_equal(torch, 1, 300, 8, 2, 128, bf, True, 100, 2e-2, g),
            _b4_equal(torch, 1, 1, 4, 2, 256, bf, True, 0, 2e-2, g),
            _b4_equal(torch, 1, 2048, 8, 2, 160, bf, False, 0, 2e-2, g),
            _b4_equal(torch, 2, 100, 8, 2, 160, bf, True, 0, 2e-2, g, T=260),
            _b4_equal(torch, 2, 150, H, KV, hd, bf, True, 0, 2e-2, g, fused=True)]
    # the CUDA-core kernel
    errs32 = [_b4_equal(torch, 2, 256, 4, 2, 160, torch.float32, True, 0, 2e-5, g),
              _b4_equal(torch, 1, 256, 4, 1, 128, torch.float32, True, 0, 2e-5, g),
              _b4_equal(torch, 1, 256, 4, 2, 160, torch.float32, True, 64, 2e-5, g),
              _b4_equal(torch, 2, 256, 4, 4, 160, torch.float32, False, 0, 2e-5, g)]
    q = torch.randn((SERVE_PROMPTS, SERVE_LEN, H, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((SERVE_PROMPTS, SERVE_LEN, KV, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((SERVE_PROMPTS, SERVE_LEN, KV, hd), generator=g, device="cuda").bfloat16()
    qt, kt, vt = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).permute(0, 2, 1, 3)
    lib_err = max_abs_err(torch, lib_out, fa_ref.attention_ref(q, k, v))
    del lib_out
    ms = timer(lambda: fa_ops.flash_attention(q, k, v), 10)
    plain_ms = timer(lambda: fa_ref.attention_ref(q, k, v), 5)
    lib_ms = timer(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    bound, by, flops, nbytes = _b4_bound_ms(q, k, True, 0, bw)
    print(f"[7] (e) B4 at the prefill's shape (q bf16 [{SERVE_PROMPTS}, {SERVE_LEN}, {H}, "
          f"{hd}], causal): tensor-core kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s, {ms / bound:.2f}x its bound, {ms / lib_ms:.2f}x "
          f"scaled_dot_product_attention)  plain {plain_ms:.3f} ms  "
          f"scaled_dot_product_attention {lib_ms:.3f} ms (its |diff| to the plain "
          f"version {lib_err:.3g})  bound {bound:.4f} ms by {by} "
          f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); {cfg.num_layers} launches "
          f"a prefill = {cfg.num_layers * ms / 1e3:.3f} s")
    del q, k, v, qt, kt, vt, params
    torch.cuda.empty_cache()
    b4 = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
              err=max(errs), f32_err=max(errs32))

    # (c) card == CPU and (d) teacher-forced decode == forward, at 2 layers of
    # full width in f32 (bf16 weights cast to f32 at each use)
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    api2 = zoo.build(cfg2)
    tree = convert.lm_params_to_numpy(api2.init_params(2))
    p_gpu = convert.lm_params_from_numpy(cfg2, tree)
    p_cpu = convert.lm_params_from_numpy(cfg2, tree, device="cpu")
    del tree
    rng = np.random.default_rng(3)
    toks_np = rng.integers(0, cfg2.vocab_size, (2, 256))
    out = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        b = {"tokens": torch.from_numpy(toks_np).to(dev)}
        kernels.reset_launches()
        with torch.no_grad():
            logits, _ = api2.prefill(p, b, 256 + 8 + 1)
        served = serve_batch(api2, p, b, 8)
        out[dev] = (logits.float().cpu(), served.tokens, kernels.launches()["flash_attention"])
    (lg, tg, ng), (lc, tc, nc) = out["cuda"], out["cpu"]
    check(ng == 4 and nc == 0, f"B4 launches card {ng} (2 prefills x 2 layers), CPU {nc}")
    dl = float((lg - lc).abs().max())
    check(dl <= LM_F32_ATOL, f"prefill logits card vs CPU |diff| {dl} > {LM_F32_ATOL}")
    check(np.array_equal(tg, tc), f"greedy tokens card {tg.tolist()} != CPU {tc.tolist()}")
    print(f"[7] (c) 2 layers of full width, f32, 2 x 256 prompts: prefill logits card vs "
          f"CPU max |diff| {dl:.3g} <= {LM_F32_ATOL}; the 9 greedy tokens of both "
          f"sequences equal: {tg[0].tolist()}")
    del p_cpu

    toks16 = torch.from_numpy(toks_np[:, :16]).cuda()
    n0 = fa_ops.flash_attention.launches
    with torch.no_grad():
        full = api2.forward(p_gpu, {"tokens": toks16}).float()
        n1 = fa_ops.flash_attention.launches
        caches = api2.init_decode_state(2, 20)
        steps = []
        for t in range(16):
            lt, caches = api2.decode_step(p_gpu, caches, toks16[:, t:t + 1])
            steps.append(lt[:, 0].float())
    dec = torch.stack(steps, dim=1)
    torch.cuda.synchronize()
    check(n1 - n0 == 2 and fa_ops.flash_attention.launches == n1,
          "forward must launch B4 once a layer and decode never")
    dd = float((full - dec).abs().max())
    check(dd <= LM_F32_ATOL, f"teacher-forced decode vs forward |diff| {dd} > {LM_F32_ATOL}")
    print(f"[7] (d) teacher-forced decode (16 steps of sdpa over the cache) vs the "
          f"forward (B4): max |diff| {dd:.3g} <= {LM_F32_ATOL}")
    del p_gpu, caches
    torch.cuda.empty_cache()
    return dict(launches=launches, b4=b4, prefill_s=res.prefill_s, decode_s=res.decode_s)


# the Mamba2 serving cell: mamba2_370m at full width and depth at the
# prefill_32k shape (32 prompts of 32,768 tokens); B5 is held against its
# plain version at that shape, and timed at 4 prompts, the size its earlier
# CUDA-core timings (PERF.md) were taken at, so its row stays comparable
SSM_PROMPTS, SSM_LEN, SSM_GEN = 32, 32768, 32
B5_PROMPTS = 4
_SSM_SCOPES = ("lm.embed", "lm.norm", "lm.ssm_in", "lm.conv", "lm.ssd", "lm.ssm_out",
               "lm.logits")
# B5 against its plain version / the recurrence: tests/test_kernels.py's
# tolerances, absolute and relative alike (|got - want| <= tol + tol |want|)
B5_BF16_TOL, B5_F32_TOL = 5e-2, 1e-3
# bf16 B5 against the recurrence in f32 on the same bf16 inputs: the largest
# |y - want| / |want| over the rows (b, s, h) of P values. The tensor-core
# kernel rounds four things to bf16, each by at most u = 2^-8 of itself:
# the decayed scores, w_j x_j, the state's snapshot and y. Where a row's
# terms do not cancel that bounds it by 3u = 1.2e-2 (the state's path: w x,
# snapshot, y); where they cancel, the errors add in quadrature, and rows of
# few values (P 8) spread the most. PERF.md Sec. 6 derives it.
B5_BF16_ROW_REL = 2e-2


def _b5_bound_ms(x, Bm, Q, bw):
    """B5's least time: the larger of its bytes (x read and y written, B and
    C read once, dt read, the state written) at the memory's rate and its
    FLOPs (C B^T once a group, the causal products over the Q(Q+1)/2 pairs,
    the inter-chunk term and the state update) at the card's peak for the
    inputs' type. Returns (ms, by, flops, bytes)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    e, nc, pairs = x.element_size(), S // Q, Q * (Q + 1) // 2
    nbytes = 2 * B * S * H * P * e + 2 * B * S * G * N * e + 4 * B * S * H + 4 * B * H * N * P
    flops = 2 * B * nc * (G * N * pairs + H * (P * pairs + 2 * Q * N * P))
    f_ms = flops / PEAK[str(x.dtype).split(".")[1]] * 1e3
    b_ms = nbytes / bw * 1e3
    return max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes"), flops, nbytes


def _b5_wgmma_flops(B, S, H, N, P, Q) -> int:
    """The FLOPs of wgmma the tensor-core kernel issues, at its padded
    widths: per (b, h, chunk), C_I B_J^T and S x_J over the causal tile
    pairs, the inter-chunk term per query tile (twice: the state's bf16 hi
    and lo) and the state update per key tile (C B^T once a head, not once a
    group)."""
    nt, NP, NBX = -(-Q // 64), -(-P // 32) * 32, -(-N // 64)
    K = 64 * NBX   # whole boxes of N
    per = nt * (nt + 1) // 2 * 64 * 64 * (K + NP) + 2 * nt * 64 * NP * K + nt * 64 ** 3 * NBX
    return 2 * B * H * (S // Q) * per


def _b5_operands(torch, B, S, H, G, N, P, dtype, g, *, strided, model=False):
    """x, B and C as views into one [B, S, width] buffer, as the model's conv
    output holds them (contiguous copies unless ``strided``). ``model``: the
    conv output's own width H*P + 2*G*N and the mamba2 layer's statistics
    at init (silu'd conv outputs, dt = softplus of a unit normal, A = -1 on
    every head); else 8 columns wider and tests/test_kernels.py's statistics
    (normal x, B and C / 2, dt = softplus / 2, a distinct A < 0 per head)."""
    F = torch.nn.functional
    width = H * P + 2 * G * N + (8 if strided and not model else 0)
    buf = torch.randn((B, S, width), generator=g, device="cuda")
    if model:
        F.silu(buf, inplace=True)
    else:
        buf[..., H * P:] *= 0.5
    buf = buf.to(dtype)
    x = buf[..., :H * P].reshape(B, S, H, P)
    Bm = buf[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = buf[..., H * P + G * N:H * P + 2 * G * N].reshape(B, S, G, N)
    if not strided:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = F.softplus(torch.randn((B, S, H), generator=g, device="cuda"))
    if model:
        a = -torch.ones((H,), device="cuda")
    else:
        dt = dt * 0.5
        a = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.3)
    return x, dt, a, Bm, Cm


def _b5_close(torch, got, want, tol, what) -> float:
    """allclose with atol = rtol = tol, one batch entry at a time (the
    served prefill's y in f64 would take 17 GB); returns max |diff|."""
    worst = err = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        diff = (g - w).abs()
        worst = max(worst, float((diff - tol * w.abs()).max()))
        err = max(err, float(diff.max()))
    check(worst <= tol, f"B5 {what}: |diff| exceeds {tol} + {tol} |want| "
                        f"(max |diff| {err})")
    return err


def _b5_rows(torch, got, x, dt, a, Bm, Cm, what) -> float:
    """Each row of bf16 ``got`` (the last got.shape[1] positions) against the
    f32 recurrence over (x, dt, a, Bm, Cm): returns the largest
    |y - want| / |want|, raising above B5_BF16_ROW_REL."""
    from repro_torch.kernels.ssd_scan import ref as ss_ref

    want, _ = ss_ref.ssd_ref_model_layout(x.float(), dt, a, Bm.float(), Cm.float())
    rel = _row_rel_err(torch, got, want[:, want.shape[1] - got.shape[1]:])
    check(rel <= B5_BF16_ROW_REL, f"B5 {what}: a row is {rel} of its norm off the f32 "
                                  f"recurrence, > {B5_BF16_ROW_REL}")
    return rel


def _b5_equal(torch, B, S, H, G, N, P, Q, g, *, strided, init, dtype):
    """B5 on its route for ``dtype``: f32 (the CUDA-core kernel) against the
    per-token recurrence (ssd_ref) at B5_F32_TOL; bf16 (the tensor-core
    kernel) against its plain version at B5_BF16_TOL and each row against
    the f32 recurrence. With ``init`` the second half of the sequence runs
    from the first half's state."""
    from repro_torch.kernels.ssd_scan import ops as ss_ops, ref as ss_ref

    x, dt, a, Bm, Cm = _b5_operands(torch, B, S, H, G, N, P, dtype, g, strided=strided)
    n0, t0 = ss_ops.ssd_scan.launches, ss_ops.ssd_scan.tensor_core_launches
    mid, args = None, (x, dt, a, Bm, Cm)
    if init:
        h = S // 2
        _, mid = ss_ops.ssd_scan(x[:, :h], dt[:, :h], a, Bm[:, :h], Cm[:, :h], chunk=Q)
        check(float(mid.abs().max()) > 0.1, "B5: the carried state is ~0")
        args = (x[:, h:], dt[:, h:], a, Bm[:, h:], Cm[:, h:])
    y, st = ss_ops.ssd_scan(*args, chunk=Q, init_state=mid)
    bf16 = dtype == torch.bfloat16
    if bf16:
        want_y, want_st = ss_ref.ssd_scan_ref(*args, chunk=Q, init_state=mid)
    else:
        want_y, want_st = ss_ref.ssd_ref_model_layout(x, dt, a, Bm, Cm)
        want_y = want_y[:, S - y.shape[1]:]
    torch.cuda.synchronize()
    check(ss_ops.ssd_scan.launches == n0 + 1 + int(init), "B5 not launched")
    tc = ss_ops.ssd_scan.tensor_core_launches - t0
    check(tc == (1 + int(init)) * bf16, f"B5 {dtype} went to the wrong route")
    what = (f"[B, S, H, G, N, P, Q] = [{B}, {S}, {H}, {G}, {N}, {P}, {Q}] "
            f"{str(dtype).split('.')[1]}{' strided' if strided else ''}"
            f"{' init_state' if init else ''}")
    tol = B5_BF16_TOL if bf16 else B5_F32_TOL
    err = max(_b5_close(torch, y, want_y, tol, what),
              _b5_close(torch, st, want_st, tol, what + " state"))
    if bf16:
        rel = _b5_rows(torch, y, x, dt, a, Bm, Cm, what)
        print(f"[8] (b) B5 {what} (tensor cores) vs its plain version: max |diff| {err:.3g} "
              f"(atol = rtol = {tol}); rows vs the f32 recurrence {rel:.3g} of their norm "
              f"<= {B5_BF16_ROW_REL}")
    else:
        print(f"[8] (b) B5 {what} (CUDA cores) vs the recurrence: max |diff| {err:.3g} "
              f"(atol = rtol = {tol})")
    return err


def phase_serve_ssm(torch, np, kernels, timer, bw):
    """Phase 8: batched serving of mamba2_370m at full size on the card."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch import convert
    from repro_torch.config import get_config
    from repro_torch.kernels.ssd_scan import ops as ss_ops, ref as ss_ref
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import zoo

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("mamba2_370m"), param_dtype="bfloat16")
    api = zoo.build(cfg)
    t0 = time.perf_counter()
    params = api.init_params(0)
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(params))
    H, P, G, N, Q = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state,
                     cfg.ssm_chunk)
    print(f"[8] mamba2_370m: {cfg.num_layers} layers, d_model {cfg.d_model}, d_inner "
          f"{cfg.ssm_d_inner}, {H} SSD heads of {P}, state {N}, {G} group, conv "
          f"{cfg.ssm_conv_width}, chunk {Q}, vocab {cfg.padded_vocab} (tied); "
          f"{cfg.param_count() / 1e6:.1f} M params, weights {w_bytes / 1e9:.3f} GB bf16, "
          f"made on the card in {time.perf_counter() - t0:.2f} s")

    # (a) the serve path: a short warm-up, then the measured run
    dev_gen = torch.Generator(device="cuda").manual_seed(1)
    serve_batch(api, params, zoo.make_demo_batch(cfg, dev_gen, SSM_PROMPTS, 512), 2)
    batch = zoo.make_demo_batch(cfg, dev_gen, SSM_PROMPTS, SSM_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = serve_batch(api, params, batch, SSM_GEN)
    launches = kernels.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ntok = SSM_PROMPTS * SSM_LEN
    state_bytes = cfg.num_layers * SSM_PROMPTS * H * N * P * 4
    dec_bound = (w_bytes + 2 * state_bytes) / bw
    # the prefill's bound: its matrix products (in_proj, out_proj, the last
    # position's logits) and B5's FLOPs at the bf16 peak
    gemm = 2 * ntok * cfg.num_layers * cfg.d_model * (
        2 * cfg.ssm_d_inner + 2 * G * N + H + cfg.ssm_d_inner)
    gemm += 2 * SSM_PROMPTS * cfg.d_model * cfg.padded_vocab
    xs = torch.empty((SSM_PROMPTS, SSM_LEN, H, P), dtype=torch.bfloat16, device="meta")
    bs = torch.empty((SSM_PROMPTS, SSM_LEN, G, N), dtype=torch.bfloat16, device="meta")
    pre_b5_flops = _b5_bound_ms(xs, bs, Q, bw)[2]
    pre_bound = (gemm + cfg.num_layers * pre_b5_flops) / PEAK["bfloat16"]
    b5_bound, b5_by, b5_flops, b5_bytes = _b5_bound_ms(xs[:B5_PROMPTS], bs[:B5_PROMPTS], Q, bw)
    print(f"[8] (a) serve {SSM_PROMPTS} x {SSM_LEN} prompts, {SSM_GEN} generated: prefill "
          f"{res.prefill_s:.3f} s = {ntok / res.prefill_s:.0f} prompt tokens/s (bound "
          f"{pre_bound:.4f} s by operations: "
          f"{(gemm + cfg.num_layers * pre_b5_flops) / 1e12:.1f} "
          f"TFLOP of GEMMs and B5 at the bf16 peak = {ntok / pre_bound:.0f} tokens/s); "
          f"decode {res.decode_s:.3f} s = {SSM_GEN * SSM_PROMPTS / res.decode_s:.1f} "
          f"tokens/s, {1e3 * res.decode_s / SSM_GEN:.2f} ms a step (bound "
          f"{1e3 * dec_bound:.3f} ms by bytes: {w_bytes / 1e9:.3f} GB of weights + "
          f"{2 * state_bytes / 1e9:.3f} GB of state read and written = "
          f"{SSM_PROMPTS / dec_bound:.0f} tokens/s); peak memory {peak_gb:.2f} GB")
    tc_b5 = ss_ops.ssd_scan.tensor_core_launches
    # B5_PROMPTS prompts: the prefill rate beside the CUDA-core kernel's
    # (2.161 s for 4 x 32,768 on an H100 80GB HBM3 at 700 W, PERF.md)
    small = serve_batch(api, params, zoo.make_demo_batch(cfg, dev_gen, B5_PROMPTS, SSM_LEN), 1)
    print(f"[8] (a) prefill of {B5_PROMPTS} x {SSM_LEN} prompts: {small.prefill_s:.3f} s = "
          f"{B5_PROMPTS * SSM_LEN / small.prefill_s:.0f} prompt tokens/s (with the "
          f"CUDA-core B5: 2.161 s = 60,662)")
    del small
    print(f"[8] (a) launches: prefill {res.prefill_launches}, decode {res.decode_launches}; "
          f"B5 on the tensor-core route {tc_b5}")
    pre_b5, dec_b5 = res.prefill_launches["ssd_scan"], res.decode_launches["ssd_scan"]
    check(pre_b5 == cfg.num_layers, f"B5 launched {pre_b5} times in the prefill, not "
                                    f"once per layer ({cfg.num_layers})")
    check(dec_b5 == 0, f"B5 launched {dec_b5} times in decode")
    check(tc_b5 == pre_b5, f"{pre_b5 - tc_b5} of the prefill's B5 launches missed the "
                           f"tensor-core route")
    check(launches == dict.fromkeys(launches, 0) | {"ssd_scan": cfg.num_layers},
          f"launches of the run: {launches}")
    toks = res.tokens
    check(toks.shape == (SSM_PROMPTS, SSM_GEN + 1), f"tokens shape {toks.shape}")
    check(((toks >= 0) & (toks < cfg.vocab_size)).all(), "token outside the vocabulary")
    print(f"[8] (a) first sequence: {toks[0].tolist()}")

    # (d) profile one prefill and one decode step by scope
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    named = (("B5 kernel", "ssd_scan_tc_kernel"),)
    with torch.no_grad():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, caches = api.prefill(params, batch, 0)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        pre = _breakdown(torch, prof, wall, "[8]", _SSM_SCOPES, named, what="prefill")
        tok = torch.argmax(logits[:, :, : cfg.vocab_size], dim=-1)
        check(torch.isfinite(logits.float()).all().item(), "non-finite prefill logits")
        api.decode_step(params, caches, tok)          # warm the decode shapes
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, caches = api.decode_step(params, caches, tok)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dec = _breakdown(torch, prof, wall, "[8]", _SSM_SCOPES, named, what="decode step")
        check(torch.isfinite(logits.float()).all().item(), "non-finite decode logits")
    del caches, logits, batch
    check(pre["B5 kernel"] > 0, "the profiled prefill shows no B5 tensor-core kernel")
    print(f"[8] (d) B5 is {100 * pre['B5 kernel'] / pre['device_ms']:.1f} % of prefill "
          f"device time; the prefill's device is idle "
          f"{100 * (1 - pre['device_ms'] / pre['wall_ms']):.1f} % of it, the decode "
          f"step's {100 * (1 - dec['device_ms'] / dec['wall_ms']):.1f} %")
    del params
    torch.cuda.empty_cache()

    # (b) B5 against its plain version at the served prefill's shape
    # (SSM_PROMPTS prompts; bf16, the conv output's views and the model's
    # statistics), the rows of its last prompt against the f32 recurrence;
    # its first B5_PROMPTS prompts alone (the timed shape: the same bits as
    # in the served call, each row against the recurrence); more bf16
    # shapes; and f32 against the recurrence
    g = torch.Generator(device="cuda").manual_seed(8)
    xa, dta, a, Ba, Ca = _b5_operands(torch, SSM_PROMPTS, SSM_LEN, H, G, N, P,
                                      torch.bfloat16, g, strided=True, model=True)
    check(xa.stride(1) == H * P + 2 * G * N, "B5's operands are not the conv's views")
    span = SSM_PROMPTS * SSM_LEN * xa.stride(1)   # the conv output's elements
    n0, t0 = ss_ops.ssd_scan.launches, ss_ops.ssd_scan.tensor_core_launches
    y, st = ss_ops.ssd_scan(xa, dta, a, Ba, Ca, chunk=Q)
    want_y, want_st = ss_ref.ssd_scan_ref(xa, dta, a, Ba, Ca, chunk=Q)
    torch.cuda.synchronize()
    check(ss_ops.ssd_scan.launches == n0 + 1, "B5 not launched")
    check(ss_ops.ssd_scan.tensor_core_launches == t0 + 1, "bf16 B5 missed the tensor cores")
    check(y.dtype == torch.bfloat16 and y.shape == xa.shape, "B5 output dtype/shape")
    what = (f"at the served prefill's shape (x bf16 [{SSM_PROMPTS}, {SSM_LEN}, {H}, {P}], "
            f"Q {Q}; the conv output {span / 2 ** 31:.2f} x 2^31 elements)")
    errs = [_b5_close(torch, y, want_y, B5_BF16_TOL, what),
            _b5_close(torch, st, want_st, B5_BF16_TOL, what + " state")]
    last = slice(SSM_PROMPTS - 1, SSM_PROMPTS)
    rel = _b5_rows(torch, y[last], xa[last], dta[last], a, Ba[last], Ca[last],
                   what + ", last prompt")
    print(f"[8] (b) B5 {what} (tensor cores) vs its plain version: max |diff| y "
          f"{errs[0]:.3g}, state {errs[1]:.3g} (atol = rtol = {B5_BF16_TOL}); rows of the "
          f"last prompt vs the f32 recurrence {rel:.3g} of their norm <= {B5_BF16_ROW_REL}")
    x, dt, Bm, Cm = (t[:B5_PROMPTS] for t in (xa, dta, Ba, Ca))
    y4, st4 = ss_ops.ssd_scan(x, dt, a, Bm, Cm, chunk=Q)
    check(torch.equal(y4, y[:B5_PROMPTS]) and torch.equal(st4, st[:B5_PROMPTS]),
          f"B5 on the first {B5_PROMPTS} prompts differs from the same prompts served in a "
          f"batch of {SSM_PROMPTS}")
    what = f"at the timed shape (x bf16 [{B5_PROMPTS}, {SSM_LEN}, {H}, {P}], Q {Q})"
    errs += [_b5_close(torch, y4, want_y[:B5_PROMPTS], B5_BF16_TOL, what),
             _b5_close(torch, st4, want_st[:B5_PROMPTS], B5_BF16_TOL, what + " state")]
    ymax = float(want_y[:B5_PROMPTS].float().abs().max())
    del want_y, want_st, y, st
    rel = _b5_rows(torch, y4, x, dt, a, Bm, Cm, what)
    print(f"[8] (b) B5 {what} (tensor cores): y and state equal the served call's first "
          f"{B5_PROMPTS} prompts bit for bit; vs its plain version max |diff| y "
          f"{errs[2]:.3g} (|y| up to {ymax:.1f}), state {errs[3]:.3g}; rows vs the f32 "
          f"recurrence {rel:.3g} of their norm <= {B5_BF16_ROW_REL}")
    del y4, st4
    bf, f32 = torch.bfloat16, torch.float32
    # the tensor-core kernel: G = 2 / rep 4, ragged chunks (tiles into the
    # next chunk's rows), one-box and part-box widths, a carried state
    errs += [_b5_equal(torch, 1, 512, 8, 2, 128, 64, 64, g, strided=False, init=False,
                       dtype=bf),
             _b5_equal(torch, 2, 288, 8, 2, 32, 16, 96, g, strided=True, init=False, dtype=bf),
             _b5_equal(torch, 2, 100, 4, 4, 8, 8, 20, g, strided=True, init=False, dtype=bf),
             _b5_equal(torch, 2, 192, 4, 2, 64, 40, 192, g, strided=False, init=False,
                       dtype=bf),
             _b5_equal(torch, 2, 512, 8, 2, 128, 64, 128, g, strided=True, init=True,
                       dtype=bf)]
    # the CUDA-core kernel
    errs32 = [_b5_equal(torch, 1, 512, 8, 2, 128, 64, 64, g, strided=False, init=False,
                        dtype=f32),
              _b5_equal(torch, 1, 512, 8, 2, 128, 64, 256, g, strided=True, init=False,
                        dtype=f32),
              _b5_equal(torch, 2, 288, 8, 2, 32, 16, 96, g, strided=False, init=False,
                        dtype=f32),
              _b5_equal(torch, 2, 512, 8, 2, 128, 64, 128, g, strided=True, init=True,
                        dtype=f32)]

    # (c) B5's time at the timed shape beside its bound, its plain version
    # and the CUDA-core kernel on the same shape in f32
    ms = timer(lambda: ss_ops.ssd_scan(x, dt, a, Bm, Cm, chunk=Q), 10)
    plain_ms = timer(lambda: ss_ref.ssd_scan_ref(x, dt, a, Bm, Cm, chunk=Q), 3)
    x32, B32, C32 = (t.float() for t in (x, Bm, Cm))
    f32_ms = timer(lambda: ss_ops.ssd_scan(x32, dt, a, B32, C32, chunk=Q), 3)
    del x32, B32, C32
    wgmma_flops = _b5_wgmma_flops(B5_PROMPTS, SSM_LEN, H, N, P, Q)
    print(f"[8] (c) B5 at the prefill's shape: tensor-core kernel {ms:.3f} ms "
          f"({b5_flops / ms / 1e9:.1f} TFLOP/s of the function's {b5_flops / 1e9:.1f} GFLOP; "
          f"{wgmma_flops / ms / 1e9:.1f} TFLOP/s of the {wgmma_flops / 1e9:.1f} GFLOP of "
          f"wgmma it issues; {b5_bytes / ms / 1e6:.1f} GB/s)  plain {plain_ms:.3f} ms  "
          f"CUDA-core kernel on the same shape in f32 {f32_ms:.3f} ms (in bf16, before "
          f"the tensor-core route: 25.278 ms)  bound {b5_bound:.4f} ms by {b5_by} "
          f"({b5_bytes / 1e9:.3f} GB); "
          f"kernel = {ms / b5_bound:.2f}x its bound; {cfg.num_layers} launches a prefill "
          f"of {B5_PROMPTS} prompts = {cfg.num_layers * ms / 1e3:.3f} s; no single PyTorch "
          f"call computes this function")
    del x, dt, a, Bm, Cm, xa, dta, Ba, Ca
    torch.cuda.empty_cache()
    b5 = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b5_bound, bound_by=b5_by,
              err=max(errs), f32_err=max(errs32), f32_ms=f32_ms)

    # (e) card == CPU, and teacher-forced decode == forward, at 2 layers of
    # full width in f32 (bf16 weights cast to f32 at each use)
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    api2 = zoo.build(cfg2)
    tree = convert.lm_params_to_numpy(api2.init_params(2))
    p_gpu = convert.lm_params_from_numpy(cfg2, tree)
    p_cpu = convert.lm_params_from_numpy(cfg2, tree, device="cpu")
    del tree
    toks_np = np.random.default_rng(3).integers(0, cfg2.vocab_size, (2, 512))
    out = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        b = {"tokens": torch.from_numpy(toks_np).to(dev)}
        kernels.reset_launches()
        with torch.no_grad():
            logits, _ = api2.prefill(p, b, 0)
        served = serve_batch(api2, p, b, 8)
        out[dev] = (logits.float().cpu(), served.tokens, kernels.launches()["ssd_scan"])
    (lg, tg, ng), (lc, tc, nc) = out["cuda"], out["cpu"]
    check(ng == 4 and nc == 0, f"B5 launches card {ng} (2 prefills x 2 layers), CPU {nc}")
    dl = float((lg - lc).abs().max())
    check(dl <= LM_F32_ATOL, f"prefill logits card vs CPU |diff| {dl} > {LM_F32_ATOL}")
    check(np.array_equal(tg, tc), f"greedy tokens card {tg.tolist()} != CPU {tc.tolist()}")
    print(f"[8] (e) 2 layers of full width, f32, 2 x 512 prompts (two chunks): prefill "
          f"logits card vs CPU max |diff| {dl:.3g} <= {LM_F32_ATOL}; the 9 greedy tokens "
          f"of both sequences equal: {tg[0].tolist()}")
    del p_cpu

    # prefill 256 tokens, then decode tokens 256..511 one at a time, against
    # the forward over all 512 (B5 over two chunks)
    toks = torch.from_numpy(toks_np).cuda()
    n0 = ss_ops.ssd_scan.launches
    with torch.no_grad():
        full = api2.forward(p_gpu, {"tokens": toks}).float()
        lp, caches = api2.prefill(p_gpu, {"tokens": toks[:, :256]}, 0)
        n1 = ss_ops.ssd_scan.launches
        steps = [lp[:, 0].float()]
        for t in range(256, 512):
            lt, caches = api2.decode_step(p_gpu, caches, toks[:, t:t + 1])
            steps.append(lt[:, 0].float())
    dec = torch.stack(steps, dim=1)
    torch.cuda.synchronize()
    check(n1 - n0 == 4 and ss_ops.ssd_scan.launches == n1,
          "forward and prefill must launch B5 once a layer, and decode never")
    dd = float((full[:, 255:] - dec).abs().max())
    check(dd <= LM_F32_ATOL, f"teacher-forced decode vs forward |diff| {dd} > {LM_F32_ATOL}")
    print(f"[8] (e) prefill of 256 tokens + 256 teacher-forced decode steps (the "
          f"recurrence) vs the forward over 512 (B5): max |diff| {dd:.3g} <= {LM_F32_ATOL}")
    del p_gpu, caches
    torch.cuda.empty_cache()
    return dict(launches=launches, b5=b5)


# ---------------------------------------------------------------------------
# the paper's other schemes at the main cell's size (ROADMAP A.1 + A.3)
SCHEMES = {"ttbs": dict(n=1 << 20, lam=LAM, batch_size=BCAP_MAIN, cap=1 << 22),
           "btbs": dict(lam=LAM, cap=1 << 22),
           "brs": dict(n=1 << 20),
           "sw": dict(n=1 << 20)}
_SIMPLE_SCOPES = ("manage.eval", "manage.sampler_step", "simple.tick_map", "simple.payload",
                  "manage.retrain", "manage.size")
# 32-bit operations a trip (the operations bound of a serial loop): H2's
# Philox-4x32-10 block (10 rounds of 2 high and 2 low products, 4 xors and
# 2 key adds) and BTRS's ~45 f32 operations (4 logarithms); H3's exp, log
# and ~12 f32 operations
H2_OPS_PER_TRIP, H3_OPS_PER_TRIP = 150, 14


def _h2_bound(count, p, trips, bw) -> dict:
    """H2's bound on these rows, in ms: bytes, each row's count (8), p (4)
    and result (8) once and its key (16) only where the result depends on
    it (count > 0 and 0 < p < 1), over the card's memory rate; operations,
    this run's trips times H2_OPS_PER_TRIP at the f32 peak."""
    keyed = int(((count > 0) & (p > 0) & (p < 1)).sum())
    return {"bytes": (count.numel() * (8 + 4 + 8) + 16 * keyed) / bw * 1e3,
            "operations": int(trips.sum()) * H2_OPS_PER_TRIP / PEAK["float32"] * 1e3}
# H3 at a saturated B-RS tick before its CTA-a-row design, one thread a
# row: this script's phase 9 (d) on an NVIDIA H100 80GB HBM3 at 700 W
H3_BEFORE_MS = 10.163


def _fma32(np, a, b, c):
    """a * b + c rounded once to f32 (to nearest, ties to even), exactly."""
    from fractions import Fraction

    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                     int(np.float32(x).view(np.uint32)) & 1))


def _scheme_ticks(torch, sampler, model, key, batches, bcounts):
    """The loop's tick body by hand: the final state and per-tick count,
    W and overflow on the host."""
    from repro_torch.manage import item_proto, make_manage_step

    tick = make_manage_step(sampler, model, retrain_every=RETRAIN_EVERY)
    state, params = sampler.init(item_proto(batches)), model.init()
    rows = []
    for t in range(bcounts.shape[0]):
        state, params, _ = tick(key, t, state, params,
                                {f: v[t] for f, v in batches.items()}, bcounts[t])
        rows.append(torch.stack([state.count.double(), state.total_weight.double(),
                                 state.overflow.double()]))
    return state, params, torch.stack(rows).cpu().numpy()


def _check_scheme_trace(torch, np, scheme, sampler, trace, sizes, state, batches):
    """sw / brs: count == min(n, seen) (sw: the newest rows in arrival order),
    brs: W == seen; ttbs / btbs: W_t = p W_(t-1) + B_t rounded once, no
    overflow, |S_t| within 6 sqrt(E_t) + 1 of E_t = p E_(t-1) + q B_t."""
    counts, Ws, ovs = trace[:, 0], trace[:, 1], trace[:, 2]
    seen = np.cumsum(sizes)
    if scheme in ("brs", "sw"):
        n = sampler.hyper["n"]
        check((counts == np.minimum(n, seen)).all(), f"{scheme}: count != min(n, seen)")
        check((Ws == seen).all(), f"{scheme}: W != items seen")
        if scheme == "sw":
            c = int(counts[-1])
            for f in ("x", "y"):
                rows = torch.cat([batches[f][t, :b] for t, b in enumerate(sizes)])[-c:]
                check(torch.equal(state.items[f][:c], rows),
                      f"sw: {f} is not the last {c} stream rows in arrival order")
        return f"count == min(n, seen){' and W == seen' if scheme == 'brs' else ''} on every tick"
    if scheme == "ttbs":
        p, q = sampler.hyper["p"], sampler.hyper["q"]
    else:
        p, q = math.exp(-LAM), 1.0
    p32 = np.float32(p)
    w, e, worst = np.float32(0.0), 0.0, 0.0
    for t, b in enumerate(sizes):
        w = _fma32(np, p32, w, np.float32(b))
        check(np.float32(Ws[t]) == w, f"{scheme} tick {t}: W {Ws[t]!r} != p W + B = {w!r}")
        e = p * e + q * b
        dev = abs(counts[t] - e)
        check(dev <= 6 * math.sqrt(e) + 1, f"{scheme} tick {t}: |S| {counts[t]} vs E {e:.1f}")
        worst = max(worst, dev / math.sqrt(max(e, 1.0)))
    check((ovs == 0).all(), f"{scheme}: overflow")
    return (f"W_t = p W_(t-1) + B_t (one rounding) exact, overflow 0, |S_t - E_t| <= "
            f"{worst:.2f} sqrt(E_t) on every tick")


def phase_schemes(torch, np, kernels, timer, bw, reps):
    """Phase 9: T-TBS, B-TBS, B-RS and SW at the main cell's size."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler, materialize_view
    from repro_torch.manage import make_manage_step, make_model, make_run_loop

    batches, bcounts, sizes = _main_stream(torch, "[9]")
    T = len(sizes)
    model = make_model("linreg", dim=2)
    key = prng.key(0)
    out = {}
    for scheme, hyper in SCHEMES.items():
        sampler = make_sampler(scheme, **hyper)
        run = make_run_loop(sampler, model, retrain_every=RETRAIN_EVERY)
        run(key, {f: v[:RETRAIN_EVERY] for f, v in batches.items()}, bcounts[:RETRAIN_EVERY])
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, params, trace = run(key, batches, bcounts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launches()
        want = {"tbs_step_apply": T, "binomial": T if scheme in ("ttbs", "btbs") else 0,
                "hypergeometric": T if scheme == "brs" else 0}
        print(f"[9] {scheme} ({sampler!r}): {T} ticks in {wall:.3f} s = {T / wall:.2f} "
              f"ticks/s; launches {launches}")
        for k, v in want.items():
            check(launches[k] == v, f"{scheme}: {k} launched {launches[k]} times, not {v}")
        check(all(v == 0 for k, v in launches.items() if k not in want),
              f"{scheme}: another kernel launched")
        check(np.isfinite(trace["metric"].cpu().numpy()).all(), f"{scheme}: non-finite metric")
        check(torch.isfinite(params).all().item(), f"{scheme}: non-finite params")

        st2, _, rows = _scheme_ticks(torch, sampler, model, key, batches, bcounts)
        for a, b in ((st2.items["x"], state.items["x"]), (st2.items["y"], state.items["y"]),
                     (st2.count, state.count), (st2.total_weight, state.total_weight)):
            check(torch.equal(a, b), f"{scheme}: manage_step by hand != make_run_loop")
        check((rows[:, 0] == trace["size"].cpu().numpy()).all(), f"{scheme}: size trace")
        what = _check_scheme_trace(torch, np, scheme, sampler, rows, sizes, state, batches)
        print(f"[9] {scheme}: {what}; final |S| {int(state.count)}, W "
              f"{float(state.total_weight):.1f}; metric first/last "
              f"{float(trace['metric'][0]):.4f}/{float(trace['metric'][-1]):.4f}")

        kernels.reset_launches()
        view = materialize_view(sampler.extract(prng.key(99), state))
        size = int(view.size)
        check(kernels.launches()["reservoir_compact"] == 1, f"{scheme}: B2 not launched once")
        check(size == int(state.count) == int(view.mask.sum()), f"{scheme}: view size")
        for f in ("x", "y"):
            check(torch.equal(view.items[f][:size], state.items[f][:size]),
                  f"{scheme}: materialized {f} != items[mask]")
            check(not view.items[f][size:].any(), f"{scheme}: materialized {f} tail")

        tick = make_manage_step(sampler, model, retrain_every=RETRAIN_EVERY)
        b_t = {f: v[T - 1] for f, v in batches.items()}
        check((T + 1) % RETRAIN_EVERY != 0, "sync-check tick must not retrain")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = tick(key, T, state, params, b_t, bcounts[T - 1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        check(int(res[0].count) <= res[0].cap, f"{scheme}: sync-check tick")
        print(f"[9] {scheme}: one non-retrain tick ran under set_sync_debug_mode('error')")

        entry = {"ticks_per_s": T / wall, "launches": launches}
        if scheme in ("ttbs", "brs"):
            prof_t = 4 * RETRAIN_EVERY - 1
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tick(key, prof_t, st2, params, b_t, bcounts[T - 1])
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            entry["profile"] = _breakdown(
                torch, prof, wall_ms, tag=f"[9] {scheme}", scopes=_SIMPLE_SCOPES,
                named=(("B1 kernel", "tbs_step_apply_kernel"), ("H2 kernel", "binomial_kernel"),
                       ("H3 kernel", "hypergeometric_kernel")))
        out[scheme] = entry
    return out


def phase_schemes_parity(torch, np):
    """Phase 9 (b): each scheme at n = 4,095 on the card and on the CPU."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler
    from repro_torch.data.streams import LinRegStream
    from repro_torch.manage import make_model, make_run_loop, materialize_stream

    n, bcap, T = 4095, 256, 48
    hypers = {"ttbs": dict(n=n, lam=LAM, batch_size=bcap), "btbs": dict(lam=LAM, cap=4 * n),
              "brs": dict(n=n), "sw": dict(n=n)}
    for scheme, hyper in hypers.items():
        out = {}
        for dev in ("cuda", "cpu"):
            batches, bcounts = materialize_stream(
                LinRegStream(seed=1), T, batch_size=lambda t: bcap if t < 24 else 32,
                bcap=bcap, device=dev)
            run = make_run_loop(make_sampler(scheme, **hyper, device=dev),
                                make_model("linreg", dim=2, device=dev),
                                retrain_every=RETRAIN_EVERY)
            out[dev] = run(prng.key(7), batches, bcounts)
        (sg, _, tg), (sc, _, tc) = out["cuda"], out["cpu"]
        for f in ("x", "y"):
            check(torch.equal(sg.items[f].cpu(), sc.items[f]), f"{scheme}: items[{f}] card != CPU")
        for name, a, b in (("count", sg.count, sc.count), ("overflow", sg.overflow, sc.overflow),
                           ("W", sg.total_weight, sc.total_weight),
                           ("sizes", tg["size"], tc["size"])):
            check(torch.equal(a.cpu(), b), f"{scheme}: {name} card != CPU")
        print(f"[9] (b) {scheme} at n = {n}: card == CPU bit for bit (items, count, "
              f"overflow, W, sizes of {T} ticks); final |S| {int(sc.count)}")


def _moments_ok(torch, x, mean, var, what):
    """Sample mean and variance within 5 standard errors of the analytic
    ones (the variance's from the sample's fourth central moment)."""
    x = x.double()
    N = x.numel()
    m = float(x.mean())
    d = x - m
    s2 = float((d * d).mean())
    m4 = float((d ** 4).mean())
    se_m = math.sqrt(max(var, 1e-300) / N)
    se_v = math.sqrt(max(m4 - s2 * s2, 1e-300) / N)
    check(abs(m - mean) <= 5 * se_m and abs(s2 - var) <= 5 * se_v,
          f"{what}: mean {m:.4f} var {s2:.4f} vs {mean:.4f} / {var:.4f} "
          f"(5 SE: {5 * se_m:.4f} / {5 * se_v:.4f})")
    return (m - mean) / se_m, (s2 - var) / se_v


def phase_variates(torch, np, timer, bw, reps):
    """Phase 9 (c): H2 and H3 against their plain versions on a sweep,
    against the analytic moments, and timed at the main path's shapes."""
    dev, rows, draws = "cuda", 65_536, 1 << 20
    from repro_torch.core import prng, rng
    from repro_torch.kernels import _bench
    from repro_torch.kernels.variates import bench as va_bench, cases, kernel as va_kernel
    from repro_torch.kernels.variates import ops as va_ops, ref as va_ref

    # (a) H2 on a sweep of 65,536 rows, bit for bit
    keys, count, p = cases.binomial_rows(rows, dev, seed=1)
    got = va_ops.binomial(keys, count, p)
    want, trips = va_ref.binomial_ref(keys, count, p, return_trips=True)
    torch.cuda.synchronize()
    bad = (got != want).nonzero().flatten()
    for i in bad[:20].tolist():
        print(f"[9] (c) H2 differs: count {int(count[i])} p {float(p[i])!r} key "
              f"{keys[i].tolist()}: kernel {int(got[i])}, plain {int(want[i])}")
    check(bad.numel() == 0, f"H2 differs from its plain version on {bad.numel()} rows")
    check(((got >= 0) & (got <= count)).all().item(), "H2 outside [0, count]")
    inv = (count.float() * torch.minimum(p, 1 - p) <= 10).sum().item()
    print(f"[9] (c) H2 == plain bit for bit on {rows} rows ({inv} on inversion, the rest "
          f"BTRS or edges; counts up to {int(count.max())}; trips up to {int(trips.max())})")
    # (b) H3 on a sweep of 65,536 rows (supports up to 65,537), bit for bit
    u, k, a, b = cases.hypergeometric_rows(rows, dev, seed=2)
    got = va_ops.hypergeometric(u, k, a, b, cases.H3_TRIPS)
    t0 = time.perf_counter()
    want = va_ref.hypergeometric_ref(u, k, a, b, cases.H3_TRIPS)
    torch.cuda.synchronize()
    bad = (got != want).nonzero().flatten()
    for i in bad[:20].tolist():
        print(f"[9] (c) H3 differs: u {float(u[i])!r} k {int(k[i])} a {int(a[i])} b "
              f"{int(b[i])}: kernel {int(got[i])}, plain {int(want[i])}")
    check(bad.numel() == 0, f"H3 differs from its plain version on {bad.numel()} rows")
    width = (torch.minimum(a, k) - torch.clamp(k - b, min=0) + 1).max().item()
    print(f"[9] (c) H3 == plain bit for bit on {rows} rows (supports up to {width} wide; "
          f"the plain version took {time.perf_counter() - t0:.1f} s)")
    # H3's block-edge rows: hits on the first and last trip of its blocks,
    # hi mid-block, supports of one block and one more trip, the guard;
    # under the full trips bound and caps inside and at its first block
    eu, ek, ea, eb, aim = cases.hypergeometric_edge_rows(dev)
    B = va_kernel.H3_BLOCK
    for trips in (cases.H3_TRIPS, cases.H3_CAP_MID_BLOCK, 1, B, B + 1):
        got = va_ops.hypergeometric(eu, ek, ea, eb, trips)
        want = va_ref.hypergeometric_ref(eu, ek, ea, eb, trips)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"H3 differs from its plain version on its block-edge "
              f"rows at trips {trips}: {got.tolist()} vs {want.tolist()}")
        if trips == cases.H3_TRIPS:
            ends = (got - torch.clamp(ek - eb, min=0)).tolist()
    print(f"[9] (c) H3 == plain bit for bit on {ek.numel()} block-edge rows (blocks of {B} "
          f"trips; draws end on trips {ends} of the full bound) at trips {cases.H3_TRIPS}, "
          f"{cases.H3_CAP_MID_BLOCK}, 1, {B}, {B + 1}")

    # (c) moments on the card
    N = draws
    for c, pp in ((20, 0.3), (1000, 0.004), (1 << 20, math.exp(-LAM)), (BCAP_MAIN, 0.4729)):
        x = va_ops.binomial(rng.binomial_keys(prng.key(c), (N,), dev),
                            torch.full((N,), c, device=dev),
                            torch.full((N,), pp, device=dev))
        p32 = float(np.float32(pp))
        zm, zv = _moments_ok(torch, x, c * p32, c * p32 * (1 - p32), f"H2 Bin({c}, {pp})")
        print(f"[9] (c) H2 Bin({c}, {pp:.4f}) over {N} draws: mean and variance within "
              f"{zm:+.2f} / {zv:+.2f} SE")
    # H3 against the analytic moments where its f32 cdf is accurate (JAX's
    # pmf-test triple and one more), and at two main-path triples against
    # the exact distribution of its f32 algorithm (kernels/variates/ref.py
    # hypergeometric_implied), with the analytic moments beside it: there the
    # reference algorithm itself is biased (ROADMAP C.8)
    def hg(kk, aa, bb, M):
        u = prng.uniform(prng.key(kk + aa), (M,), dev)
        return va_ops.hypergeometric(u, torch.full((M,), kk, device=dev),
                                     torch.full((M,), aa, device=dev),
                                     torch.full((M,), bb, device=dev), cases.H3_TRIPS)

    for kk, aa, bb in ((7, 10, 15), (30, 50, 80)):
        tot = aa + bb
        mean = kk * aa / tot
        var = kk * (aa / tot) * (bb / tot) * (tot - kk) / (tot - 1)
        zm, zv = _moments_ok(torch, hg(kk, aa, bb, N), mean, var, f"H3 HyperGeo({kk}, {aa}, {bb})")
        print(f"[9] (c) H3 HyperGeo({kk}, {aa}, {bb}) over {N} draws: mean and variance "
              f"within {zm:+.2f} / {zv:+.2f} SE of the analytic ones")
    for kk, aa, bb in ((1 << 20, BCAP_MAIN, 1 << 20), (1 << 20, BCAP_MAIN // 8, 1_638_400)):
        M = draws >> 4
        vals, probs = va_ref.hypergeometric_implied(kk, aa, bb, cases.H3_TRIPS)
        imean = float((vals * probs).sum())
        ivar = float((vals * vals * probs).sum()) - imean * imean
        zm, zv = _moments_ok(torch, hg(kk, aa, bb, M), imean, ivar,
                             f"H3 HyperGeo({kk}, {aa}, {bb}) vs its f32 algorithm")
        tot = aa + bb
        mean = kk * aa / tot
        var = kk * (aa / tot) * (bb / tot) * (tot - kk) / (tot - 1)
        print(f"[9] (c) H3 HyperGeo({kk}, {aa}, {bb}) over {M} draws: within {zm:+.2f} / "
              f"{zv:+.2f} SE of the f32 algorithm's mean {imean:.2f} / variance {ivar:.1f} "
              f"(its cdf reaches {1 - float(probs[-1]):.7f}: {float(probs[-1]):.2e} of the "
              f"draws take hi by the guard); analytic {mean:.2f} / {var:.1f} (ROADMAP C.8)")

    # (d) times at the main path's shapes: H2 on a T-TBS tick's two rows
    # (m ~ Bin(|S|, p), k ~ Bin(B, q)), H3 on a saturated B-RS tick
    # (C = 2^20, B = 65,536, W = 2^20)
    q = SCHEMES["ttbs"]["n"] * (1 - math.exp(-LAM)) / BCAP_MAIN
    keys = rng.binomial_keys(prng.key(5), (2,), dev)
    count = torch.tensor([1 << 20, BCAP_MAIN], device=dev)
    p = torch.tensor([math.exp(-LAM), q], dtype=torch.float32, device=dev)
    h2_ms = timer(lambda: va_ops.binomial(keys, count, p), reps)
    plain2_ms = timer(lambda: va_ref.binomial_ref(keys, count, p), 5)
    lib2_ms = timer(lambda: torch.binomial(count.float(), p), reps)
    _, tr2 = va_ref.binomial_ref(keys, count, p, return_trips=True)
    b2 = _h2_bound(count, p, tr2, bw)
    print(f"[9] (d) H2, a T-TBS tick's 2 rows (Bin(2^20, {math.exp(-LAM):.4f}), Bin(65536, "
          f"{q:.4f}); {int(tr2.sum())} trips): kernel {h2_ms:.4f} ms; plain {plain2_ms:.4f} ms; "
          f"torch.binomial {lib2_ms:.4f} ms; bound {max(b2.values()):.2e} ms "
          f"(bytes {b2['bytes']:.2e}, operations {b2['operations']:.2e})")
    # H3 on B-RS's rows M ~ HyperGeo(C, B, W) at the main cell, u = 0.5: a
    # saturated tick (C = W = 2^20), a late one (W = 47 B), the first (W =
    # 0: one trip), and the 65,536-row sweep; beside each the chain floor
    # (its longest row's trips x 4 cycles at the top SM clock)
    mhz = _bench.max_sm_clock_mhz()
    h3 = {}
    for name, (u, k1, a1, b1) in va_bench.shapes(dev).items():
        ms = timer(lambda: va_ops.hypergeometric(u, k1, a1, b1, cases.H3_TRIPS), reps)
        tr = va_ops.hypergeometric(u, k1, a1, b1, cases.H3_TRIPS) - torch.clamp(k1 - b1, min=0) + 1
        trips3, longest = int(tr.sum()), int(tr.max())
        bnd = {"bytes": u.numel() * (4 + 3 * 8 + 8) / bw * 1e3,
               "operations": trips3 * H3_OPS_PER_TRIP / PEAK["float32"] * 1e3}
        h3[name] = dict(ms=ms, trips=trips3, longest_trips=longest, bound_ms=max(bnd.values()),
                        bound_by=max(bnd, key=bnd.get),
                        chain_floor_ms=va_bench.chain_floor_ms(longest, mhz))
        print(f"[9] (d) H3 {name} ({u.numel()} rows, {trips3} trips, the longest {longest}): "
              f"kernel {ms:.4f} ms = {1e6 * ms / longest:.2f} ns a trip of the longest row; "
              f"chain floor {h3[name]['chain_floor_ms']:.4f} ms (x 4 cycles at {mhz:.0f} MHz); "
              f"bound {h3[name]['bound_ms']:.2e} ms ({h3[name]['bound_by']})"
              + (f"; a thread a row before: {H3_BEFORE_MS} ms" if name == "saturated" else ""))
    u, k1, a1, b1 = va_bench.shapes(dev)["saturated"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    va_ref.hypergeometric_ref(u, k1, a1, b1, cases.H3_TRIPS)
    ev[1].record()
    torch.cuda.synchronize()
    plain3_ms = ev[0].elapsed_time(ev[1])
    print(f"[9] (d) H3 saturated: plain version {plain3_ms:.1f} ms (one call)")
    sat = h3.pop("saturated")
    return {"binomial": dict(err=0.0, ms=h2_ms, plain_ms=plain2_ms, library_ms=lib2_ms,
                             bound_ms=max(b2.values()), bound_by=max(b2, key=b2.get)),
            "hypergeometric": dict(err=0.0, ms=sat["ms"], plain_ms=plain3_ms, library_ms=None,
                                   bound_ms=sat["bound_ms"], bound_by=sat["bound_by"],
                                   trips=sat["trips"], chain_floor_ms=sat["chain_floor_ms"],
                                   shapes=h3)}


# ---------------------------------------------------------------------------
# closed-loop adaptive decay (ROADMAP A.5) and the T-TBS bank (A.6)
ADAPT = dict(lam0=0.03, lam_min=0.003, lam_max=0.5)
FLIP, FARM_TRIALS, FARM_FROM, FARM_TICKS = 24, 8, 12, 24
ADAPT_BANK = dict(lam0=LAM_BANK, lam_min=0.005, lam_max=0.5)
N_TTBS_BANK = N_BANK          # cap 4 n = 256


def _adaptive_stream(torch, tag: str):
    """The main cell's stream with its coefficients flipped to mode 1 from
    tick FLIP on: LinRegStream(seed=0), 24 ticks of 65,536 items then 24 of
    8,192 (bcap 65,536)."""
    from repro_torch.data.streams import LinRegStream
    from repro_torch.manage import materialize_stream

    T = 48
    sizes = [BCAP_MAIN if t < 24 else 8192 for t in range(T)]
    batches, bcounts = materialize_stream(
        LinRegStream(seed=0), T, batch_size=lambda t: sizes[t], bcap=BCAP_MAIN,
        mode=lambda t: 0 if t < FLIP else 1)
    torch.cuda.synchronize()
    print(f"{tag} stream: {T} ticks, {sum(sizes)} items, coefficients flipped to mode 1 "
          f"at tick {FLIP}")
    return batches, bcounts, sizes


def _leaves_equal(torch, a, b) -> bool:
    """Bit for bit over two pytrees, NaNs included."""
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.dtype != y.dtype:
            return False
        if x.dtype.is_floating_point:
            as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
            x, y = x.view(as_int), y.view(as_int)
        if not torch.equal(x, y):
            return False
    return True


def _controller_on_cpu(torch, ctrl, trace, c_card, what: str, tag: str) -> None:
    """The card's controller against the CPU's on the same losses: replay
    ``ctrl`` on the CPU over the run's metric trace ([T], or [T, Q] for Q
    per-key controllers; retrain ticks adjust), and hold every tick's rate
    to the run's ``decay`` trace and the final state to the card's
    ``c_card``, bit for bit (the f64 exp and log of the card against the
    CPU's)."""
    from torch.utils import _pytree as pytree

    metric, decay = trace["metric"].cpu(), trace["decay"].cpu()
    c = ctrl.init("cpu")
    if metric.dim() == 2:
        c = pytree.tree_map(lambda a: a.expand(metric.shape[1]).clone(), c)
    for t in range(metric.shape[0]):
        check(_leaves_equal(torch, ctrl.rate(c), decay[t]),
              f"{tag} {what}: tick {t}'s rate on the card != the CPU controller's")
        c = ctrl.observe(c, metric[t], (t + 1) % RETRAIN_EVERY == 0)
    check(_leaves_equal(torch, pytree.tree_map(lambda a: a.cpu(), c_card), c),
          f"{tag} {what}: the card's final controller state != the CPU controller's")
    print(f"{tag} {what}: the CPU controller fed the run's losses gives its rate on all "
          f"{metric.shape[0]} ticks and its final state (loglam, fast, slow, seen, hold) "
          f"bit for bit")


def phase_adaptive(torch, np, kernels):
    """Phase 10: the main cell with the loss-ratio controller, for R-TBS
    (n = 2^20 - 1) and for T-TBS and B-TBS at phase 9's sizes. R-TBS is
    also timed without the controller, in turns, and a retrain tick of
    each is profiled."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler
    from repro_torch.decay import loss_ratio
    from repro_torch.manage import item_proto, make_manage_step, make_model, make_run_loop

    batches, bcounts, sizes = _adaptive_stream(torch, "[10]")
    T = len(sizes)
    model = make_model("linreg", dim=2)
    ctrl = loss_ratio(**ADAPT)
    key = prng.key(0)
    out = {}

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(key, batches, bcounts)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    for scheme, hyper in (("rtbs", dict(n=N_MAIN, lam=LAM)), ("ttbs", SCHEMES["ttbs"]),
                          ("btbs", SCHEMES["btbs"])):
        sampler = make_sampler(scheme, **hyper)
        run = make_run_loop(sampler, model, retrain_every=RETRAIN_EVERY, controller=ctrl)
        run(key, {f: v[:RETRAIN_EVERY] for f, v in batches.items()}, bcounts[:RETRAIN_EVERY])
        torch.cuda.synchronize()
        kernels.reset_launches()
        (state, params, trace), wall = timed(run)
        launches = kernels.launches()
        want = {"tbs_step_apply": T, "binomial": T if scheme != "rtbs" else 0,
                "hypergeometric": 0, "tbs_step_apply_banked": 0}
        for k, v in want.items():
            check(launches[k] == v, f"[10] {scheme}: {k} launched {launches[k]} times, not {v}")
        if scheme == "rtbs":
            check(launches["swap_delete"] >= T, "[10] rtbs: H1 not launched on every tick")
        lam = (-torch.log(trace["decay"].double())).cpu().numpy()
        print(f"[10] {scheme} with {ctrl!r}: {T} ticks in {wall:.3f} s = {T / wall:.2f} "
              f"ticks/s; launches {launches}")
        print(f"[10] {scheme} lambda by tick: {' '.join(f'{v:.4g}' for v in lam)}")
        check(np.isfinite(trace["metric"].cpu().numpy()).all(), f"[10] {scheme}: metric")
        check(lam[FLIP - 4:FLIP].max() < ADAPT["lam0"],
              f"[10] {scheme}: lambda not below lam0 in the four ticks before the flip")
        check(lam[FLIP:FLIP + 2 * RETRAIN_EVERY + 1].max() > 0.4,
              f"[10] {scheme}: lambda did not pulse above 0.4 within two retrains of the flip")
        rates = {"controlled": [T / wall]}
        if scheme == "rtbs":
            # the same stream without the controller, timed in turns with it
            # (controlled, uncontrolled, controlled, uncontrolled)
            plain_run = make_run_loop(sampler, model, retrain_every=RETRAIN_EVERY)
            rates["uncontrolled"] = []
            for turn in range(3):
                which = "uncontrolled" if turn % 2 == 0 else "controlled"
                res, w = timed(plain_run if which == "uncontrolled" else run)
                rates[which].append(T / w)
                if which == "uncontrolled":
                    plain_state, plain_params = res[0], res[1]
            print("[10] rtbs in turns on this stream (controlled, uncontrolled, controlled, "
                  "uncontrolled): " + ", ".join(
                      f"{rates[w][i]:.2f}" for i in range(2)
                      for w in ("controlled", "uncontrolled")) + " ticks/s")

        # the same tick body by hand, the controller carried along
        tick = make_manage_step(sampler, model, retrain_every=RETRAIN_EVERY, controller=ctrl)
        st, p, c = sampler.init(item_proto(batches)), model.init(), ctrl.init("cuda")
        ms = []
        for t in range(T):
            st, p, c, m = tick(key, t, st, p, c, {f: v[t] for f, v in batches.items()},
                               bcounts[t])
            ms.append(m)
        by_hand = (st, p, {k: torch.stack([m[k] for m in ms]) for k in ms[0]})
        check(_leaves_equal(torch, (state, params, trace), by_hand),
              f"[10] {scheme}: the controlled ticks by hand != make_run_loop")
        _controller_on_cpu(torch, ctrl, trace, c, scheme, "[10]")
        # one non-retrain controlled tick with every host sync an error
        check((T + 1) % RETRAIN_EVERY != 0, "sync-check tick must not retrain")
        b_t = {f: v[T - 1] for f, v in batches.items()}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tick(key, T, st, p, c, b_t, bcounts[T - 1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        pulse = int(np.argmax(lam > 0.4))
        print(f"[10] {scheme}: lambda {lam[FLIP - 1]:.4g} before the flip, {lam[pulse]:.4g} "
              f"from tick {pulse}, {lam[-1]:.4g} at the end; the ticks by hand equal the run "
              f"bit for bit (state, params, metric, size, decay); a controlled tick ran "
              f"under set_sync_debug_mode('error')")
        out[scheme] = {"ticks_per_s": rates, "launches": launches,
                       "lam": [float(v) for v in lam]}
        if scheme == "rtbs":
            # a retrain tick of each, as phase 3 profiles main's: tick 15 on
            # the final state, with the last batch
            prof_t = 4 * RETRAIN_EVERY - 1
            plain_tick = make_manage_step(sampler, model, retrain_every=RETRAIN_EVERY)
            profs = {}
            for which, call in (
                    ("uncontrolled", lambda: plain_tick(key, prof_t, plain_state, plain_params,
                                                        b_t, bcounts[T - 1])),
                    ("controlled", lambda: tick(key, prof_t, st, p, c, b_t, bcounts[T - 1]))):
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                profs[which] = _breakdown(torch, prof, wall_ms, f"[10] rtbs {which}",
                                          _SCOPES + ("manage.controller",))
            out[scheme]["profile"] = profs
    return out


def phase_adaptive_parity(torch, np):
    """Phase 10 (d): the controlled R-TBS loop at cap 4096 on phase 4's
    stream with its coefficients flipped at tick FLIP, card against CPU."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler
    from repro_torch.data.streams import LinRegStream
    from repro_torch.decay import loss_ratio
    from repro_torch.manage import make_model, make_run_loop, materialize_stream

    n, bcap, T = 4095, 256, 48
    ctrl = loss_ratio(**ADAPT)
    out = {}
    for dev in ("cuda", "cpu"):
        batches, bcounts = materialize_stream(
            LinRegStream(seed=1), T, batch_size=lambda t: bcap if t < 24 else 32,
            bcap=bcap, device=dev, mode=lambda t: 0 if t < FLIP else 1)
        run = make_run_loop(make_sampler("rtbs", n=n, lam=LAM, device=dev),
                            make_model("linreg", dim=2, device=dev),
                            retrain_every=RETRAIN_EVERY, controller=ctrl)
        out[dev] = run(prng.key(7), batches, bcounts)
    (sg, pg, tg), (sc, pc, tc) = out["cuda"], out["cpu"]
    check(_leaves_equal(torch, tg["decay"].cpu(), tc["decay"]),
          "[10] (d) the controlled decay trace card != CPU")
    for f in ("x", "y"):
        check(torch.equal(sg.lat.items[f].cpu(), sc.lat.items[f]),
              f"[10] (d) items[{f}] card != CPU")
    check(torch.equal(sg.lat.nfull.cpu(), sc.lat.nfull), "[10] (d) nfull card != CPU")
    check(torch.equal(sg.lat.weight.cpu(), sc.lat.weight), "[10] (d) weight card != CPU")
    check(torch.equal(sg.total_weight.cpu(), sc.total_weight), "[10] (d) W card != CPU")
    check(torch.equal(tg["size"].cpu(), tc["size"]), "[10] (d) sizes card != CPU")
    check(torch.allclose(tg["metric"].cpu(), tc["metric"], rtol=1e-4, atol=1e-5),
          "[10] (d) metrics card vs CPU beyond rtol 1e-4")
    dm = float((tg["metric"].cpu() - tc["metric"]).abs().max())
    lam = (-torch.log(tc["decay"].double())).numpy()
    print(f"[10] (d) controlled rtbs at cap 4096, {T} ticks, flip at {FLIP}: card == CPU bit "
          f"for bit (decay trace, items, nfull, weight, W, sizes); metrics max |diff| "
          f"{dm:.3g} (f32 sums in another order); lambda peak {lam.max():.4g}, end "
          f"{lam[-1]:.4g}")


def phase_farm(torch, np, kernels):
    """Phase 11: a Monte-Carlo farm of the controlled main cell, its trials
    a leading dimension of the sampler's state; bit-equal to the stacked
    single runs."""
    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler
    from repro_torch.decay import loss_ratio
    from repro_torch.manage import make_model, make_run_farm, make_run_loop

    batches, bcounts, sizes = _adaptive_stream(torch, "[11]")
    sl = slice(FARM_FROM, FARM_FROM + FARM_TICKS)
    batches = {f: v[sl].contiguous() for f, v in batches.items()}
    bcounts = bcounts[sl].contiguous()
    T = FARM_TICKS
    sampler = make_sampler("rtbs", n=N_MAIN, lam=LAM)
    model = make_model("linreg", dim=2)
    ctrl = loss_ratio(**ADAPT)
    key = prng.key(1)
    farm = make_run_farm(sampler, model, retrain_every=RETRAIN_EVERY, controller=ctrl)
    farm(key, 2, {f: v[:RETRAIN_EVERY] for f, v in batches.items()}, bcounts[:RETRAIN_EVERY])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    trace = farm(key, FARM_TRIALS, batches, bcounts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    check(launches["tbs_step_apply"] == T, "[11] B1 not launched once a tick for all trials")
    check(launches["swap_delete"] >= T, "[11] H1 not launched on every tick")
    check(trace["metric"].shape == (FARM_TRIALS, T), "[11] farm trace shape")
    run = make_run_loop(sampler, model, retrain_every=RETRAIN_EVERY, controller=ctrl)
    t0 = time.perf_counter()
    singles = [run(k, batches, bcounts)[2] for k in prng.split(key, FARM_TRIALS)]
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    stacked = {k: torch.stack([tr[k] for tr in singles]) for k in singles[0]}
    check(_leaves_equal(torch, trace, stacked), "[11] the farm != the stacked single runs")
    lam = (-torch.log(trace["decay"].double())).cpu().numpy()
    metric = trace["metric"].cpu().numpy()
    check(len(set(metric[:, -1].tolist())) > 1, "[11] the trials do not differ")
    check((lam[:, FLIP - FARM_FROM:FLIP - FARM_FROM + 2 * RETRAIN_EVERY + 1].max(1) > 0.4).all(),
          "[11] a trial's lambda did not pulse above 0.4 within two retrains of the flip")
    print(f"[11] farm of {FARM_TRIALS} trials x {T} ticks (ticks {FARM_FROM}-"
          f"{FARM_FROM + T - 1} of phase 10's stream; the flip at its tick {FLIP - FARM_FROM}): "
          f"{wall:.3f} s = {FARM_TRIALS * T / wall:.2f} trial-ticks/s (the {FARM_TRIALS} "
          f"single runs one after another: {wall1:.3f} s); launches {launches}; equal to the "
          f"stacked single runs bit for bit (metric, size, decay)")
    print(f"[11] peak lambda per trial: {' '.join(f'{v:.3f}' for v in lam.max(1))}; final "
          f"metric per trial: {' '.join(f'{v:.4f}' for v in metric[:, -1])}")
    return {"trial_ticks_per_s": FARM_TRIALS * T / wall, "launches": launches,
            "single_runs_s": wall1, "farm_s": wall}


def _bank_batch_size(np, keys_h, bcounts_h) -> float:
    """A key's mean arrivals per tick it is touched: arrivals over
    (touched key, tick) pairs, from the stream's key column."""
    touched = sum(len(np.unique(keys_h[t, :int(c)])) for t, c in enumerate(bcounts_h))
    return float(sum(int(c) for c in bcounts_h)) / touched


def phase_ttbs_bank(torch, np, kernels, timer, bw, reps):
    """Phase 12: the keyed T-TBS bank at K = 2^20 through the bank loop with
    a per-key controller; H2 on the bank tick's 2b rows and B3 at cap 256."""
    from repro_torch.bank import make_bank
    from repro_torch.core import prng
    from repro_torch.data.streams import KeyedStream, LinRegStream
    from repro_torch.decay import loss_ratio
    from repro_torch.kernels.variates import ops as va_ops, ref as va_ref
    from repro_torch.manage import (make_bank_manage_step, make_bank_run_loop, make_model,
                                    materialize_stream)

    K, n, b, bcap, T, Q = K_BANK, N_TTBS_BANK, B_BANK, BCAP_BANK, T_BANK, Q_BANK
    t0 = time.perf_counter()
    stream = KeyedStream(LinRegStream(seed=0), num_keys=K, alpha=1.1, flip_every=50)
    batches, bcounts = materialize_stream(stream, T, batch_size=b, fields=("key", "x", "y"))
    keys_h, bcounts_h = batches["key"].cpu().numpy(), bcounts.cpu().numpy()
    bs = _bank_batch_size(np, keys_h, bcounts_h)
    print(f"[12] keyed stream: {T} ticks x {b} arrivals over K = {K} keys (phase 6's), "
          f"{bs:.4f} arrivals per touched key a tick, made in {time.perf_counter() - t0:.2f} s")
    bank = make_bank("ttbs", num_keys=K, n=n, lam=LAM_BANK, bcap=bcap, batch_size=bs)
    cap = bank.cap
    model = make_model("linreg", dim=2)
    ctrl = loss_ratio(**ADAPT_BANK)
    key = prng.key(0)
    run = make_bank_run_loop(bank, model, retrain_every=RETRAIN_EVERY, train_keys=range(Q),
                             per_key=True, controller=ctrl)
    run(key, {f: v[:2] for f, v in batches.items()}, bcounts[:2])   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, params, trace = run(key, batches, bcounts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    items_gb = sum(v.numel() * v.element_size() for v in state.items.values()) / 1e9
    print(f"[12] {bank!r}, per-key {ctrl!r} on the {Q} train keys: {T} ticks in "
          f"{wall:.3f} s = {T / wall:.2f} ticks/s, {T * b / wall:.0f} keyed items/s; bank "
          f"items {items_gb:.2f} GB on the card; launches {launches}")
    want = {"tbs_step_apply_banked": T, "binomial": T, "tbs_step_apply": 0,
            "swap_delete": 0, "hypergeometric": 0}
    for k, v in want.items():
        check(launches[k] == v, f"[12] {k} launched {launches[k]} times, not {v}")
    sizes = trace["size"].cpu().numpy()
    check(sizes.shape == (T, Q) and (sizes <= cap).all(), "[12] bank size > cap")
    check(trace["decay"].shape == (T, Q), "[12] decay trace shape")
    check(torch.isfinite(params).all().item(), "[12] non-finite params")
    lam = (-torch.log(trace["decay"].double())).cpu().numpy()
    print(f"[12] sizes of the {Q} train keys at the end: min {sizes[-1].min()} max "
          f"{sizes[-1].max()} (n = {n}); overflow per tick "
          f"{trace['overflow'].cpu().numpy().tolist()[:4]}...; the train keys' lambda at "
          f"the end: min {lam[-1].min():.4g} max {lam[-1].max():.4g}, peak {lam.max():.4g}")
    del state

    # (b) the tick by hand: W and pending of all K keys on the host
    tick = make_bank_manage_step(bank, model, retrain_every=RETRAIN_EVERY, train_keys=range(Q),
                                 per_key=True, controller=ctrl)
    st = bank.init({"x": torch.zeros(2, device="cuda"), "y": torch.zeros((), device="cuda")})
    from torch.utils import _pytree as pytree

    p = pytree.tree_map(lambda a: a.expand((Q,) + a.shape).clone(), model.init())
    c = pytree.tree_map(lambda a: a.expand(Q).clone(), ctrl.init("cuda"))
    base = np.float32(math.exp(-LAM_BANK))
    W = np.zeros(K, np.float32)
    pend = np.ones(K, np.float32)
    ms = []
    for t in range(T):
        bt = {f: v[t] for f, v in batches.items()}
        st, p, c, m = tick(key, t, st, p, c, bt, bcounts[t])
        ms.append(m)
        d = np.full(K, base, np.float32)
        d[:Q] = m["decay"].cpu().numpy()
        pend = (pend * d).astype(np.float32)
        u, cnt = np.unique(keys_h[t, : int(bcounts_h[t])], return_counts=True)
        W[u] = (pend[u].astype(np.float64) * W[u] + np.minimum(cnt, bcap)).astype(np.float32)
        pend[u] = 1.0
        check(np.array_equal(st.total_weight.cpu().numpy(), W), f"[12] tick {t}: W column")
        check(np.array_equal(st.pending.cpu().numpy(), pend), f"[12] tick {t}: pending column")
    check(_leaves_equal(torch, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}, trace),
          "[12] the bank ticks by hand != make_bank_run_loop")
    _controller_on_cpu(torch, ctrl, trace, c, f"the {Q} per-key controllers", "[12] (b)")
    nf = st.nfull.cpu().numpy()
    check(((nf >= 0) & (nf <= cap)).all(), "[12] nfull outside [0, cap]")
    print(f"[12] (b) the ticks by hand equal the run bit for bit; W = p_eff W + B (one "
          f"rounding) and pending = the product of each key's factors since its last touch, "
          f"exact for all {K} keys on all {T} ticks; largest buffer {int(nf.max())} of {cap}")

    # (c) one non-retrain tick under set_sync_debug_mode("error")
    t_free = T
    check((t_free + 1) % RETRAIN_EVERY != 0, "sync-check tick must not retrain")
    bt = {f: v[T - 1] for f, v in batches.items()}
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st2, p2, c2, _ = tick(key, t_free, st, p, c, bt, bcounts[T - 1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(kernels.launches()["tbs_step_apply_banked"] == 1 and kernels.launches()["binomial"] == 1,
          "[12] sync-check tick: B3 and H2 once")
    print("[12] (c) one non-retrain bank tick ran under set_sync_debug_mode('error'): no "
          "host sync; B3 and H2 launched once each")

    # profile one retrain tick
    prof_t = 4 * RETRAIN_EVERY - 1
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st2, p2, c2, _ = tick(key, prof_t, st2, p2, c2, bt, bcounts[T - 1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    profile = _breakdown(torch, prof, wall_ms, "[12]", _BANK_SCOPES + ("manage.controller",),
                         (("B3 kernel", ("tbs_step_banked_kernel",
                                         "tbs_step_banked_staged_kernel")),
                          ("H2 kernel", "binomial_kernel")))

    # (a) H2 and B3 on one tick's real operands, made by the bank's own tick
    # up to its payload pass: the rows of its one binomial launch (both
    # binomials of all b routed rows) and its slot maps
    from repro_torch.bank.bank import _ttbs_tick_map

    tk = torch.arange(Q, device="cuda")
    d = bank.base_rate(st2).expand(K).clone().index_copy_(0, tk, ctrl.rate(c2))
    r, src, _, _, _, _, (h2_keys, h2_count, h2_p) = _ttbs_tick_map(
        prng.key(5), st2, bt["key"], bcounts[T - 1], d, n=n,
        batch_size=bank.hyper["batch_size"], bcap=bcap)
    rows = h2_count.numel()
    got = va_ops.binomial(h2_keys, h2_count, h2_p)
    want, trips = va_ref.binomial_ref(h2_keys, h2_count, h2_p, return_trips=True)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"[12] (a) H2 differs from its plain version on "
          f"{int((got != want).sum())} of the bank tick's {rows} rows")
    nt = int(r.ntouched)
    h2_ms = timer(lambda: va_ops.binomial(h2_keys, h2_count, h2_p), reps)
    h2_plain = timer(lambda: va_ref.binomial_ref(h2_keys, h2_count, h2_p), 3)
    h2_lib = timer(lambda: torch.binomial(h2_count.float(), h2_p), reps)
    h2b = _h2_bound(h2_count, h2_p, trips, bw)
    # the rows the tick keeps: m's and k's of its nt touched keys
    live = torch.cat([torch.arange(nt, device="cuda"), rows // 2 + torch.arange(nt, device="cuda")])
    h2_live = _h2_bound(h2_count[live], h2_p[live], trips[live], bw)
    keyed = int(((h2_count > 0) & (h2_p > 0) & (h2_p < 1)).sum())
    one = (h2_keys[:1], torch.zeros(1, dtype=torch.int64, device="cuda"),
           torch.zeros(1, device="cuda"))
    empty_ms = timer(lambda: va_ops.binomial(*one), reps)
    print(f"[12] (a) H2 on a bank tick's {rows} rows ({nt} touched keys: counts <= "
          f"{int(h2_count[:rows // 2].max())} and <= {int(h2_count[rows // 2:].max())}, "
          f"{keyed} rows whose draw needs its key, {int(trips.sum())} trips, the longest "
          f"row {int(trips.max())}): equal to its plain version bit for bit; kernel "
          f"{h2_ms:.4f} ms; plain {h2_plain:.4f} ms; torch.binomial {h2_lib:.4f} ms; bound "
          f"{max(h2b.values()):.4f} ms (bytes {h2b['bytes']:.4f}, operations "
          f"{h2b['operations']:.4f}); bound over the {2 * nt} rows of the touched keys "
          f"{max(h2_live.values()):.4f} ms (bytes {h2_live['bytes']:.4f}, operations "
          f"{h2_live['operations']:.4f}); a one-row launch that returns at once "
          f"{empty_ms:.4f} ms; kernel - bound = {h2_ms - max(h2b.values()):.4f} ms")

    # B3 at cap 256 on the same tick's map (simple.draw_ttbs's permutations)
    payload = {"x": bt["x"], "y": bt["y"]}
    err = max(_b3_equal(torch, st2.items["x"], payload["x"], src, r, bcap,
                        f"x f32[., 2] at K = 2^20, cap {cap}", tag="[12]"),
              _b3_equal(torch, st2.items["y"], payload["y"], src, r, bcap,
                        f"y f32[.] at K = 2^20, cap {cap}", tag="[12]"))
    items = st2.items
    row_bytes = [leaf[0, 0].numel() * leaf.element_size() for leaf in items.values()]
    nbytes, n_wr, n_take, npay = _b3_bytes(torch, src, r, row_bytes, cap, bcap)

    def fused():
        from repro_torch.kernels.tbs_step import ops as ts_ops

        ts_ops.tbs_step_apply_banked(items, payload, src, order=r.order, starts=r.starts,
                                     touched=r.touched, ntouched=r.ntouched, bcap=bcap)

    b3_ms = timer(fused, reps)
    b3_bound = nbytes / bw * 1e3
    print(f"[12] B3 at cap {cap} (ntouched {int(r.ntouched)}, {n_wr} of "
          f"{int(r.ntouched) * cap} slots written per leaf, {n_take} of them batch rows, x + y "
          f"in one launch): kernel {b3_ms:.4f} ms, bound {b3_bound:.4f} ms; kernel = "
          f"{b3_ms / b3_bound:.2f}x its bound")
    return dict(ticks_per_s=T / wall, items_per_s=T * b / wall, launches=launches,
                profile=profile, batch_size=bs,
                h2=dict(rows=rows, ms=h2_ms, plain_ms=h2_plain,
                        library_ms=h2_lib, bound_ms=max(h2b.values()),
                        bound_by=max(h2b, key=h2b.get), trips=int(trips.sum()),
                        live_rows=2 * nt, live_bound_ms=max(h2_live.values()),
                        empty_launch_ms=empty_ms, err=0.0, launches=launches["binomial"]),
                b3=dict(cap=cap, ms=b3_ms, bound_ms=b3_bound, err=err))


def phase_ttbs_bank_parity(torch, np):
    """Phase 12 (d): the T-TBS bank loop at K = 4096 with per-key
    controllers, card against CPU."""
    from repro_torch.bank import make_bank
    from repro_torch.core import prng
    from repro_torch.data.streams import KeyedStream, LinRegStream
    from repro_torch.decay import loss_ratio
    from repro_torch.manage import make_bank_run_loop, make_model, materialize_stream

    out = {}
    for dev in ("cuda", "cpu"):
        batches, bcounts = materialize_stream(
            KeyedStream(LinRegStream(seed=1), num_keys=4096, alpha=1.1, flip_every=50),
            8, batch_size=2048, fields=("key", "x", "y"), device=dev)
        run = make_bank_run_loop(
            make_bank("ttbs", num_keys=4096, n=N_TTBS_BANK, lam=LAM_BANK, bcap=BCAP_BANK,
                      batch_size=2.0, device=dev),
            make_model("linreg", dim=2, device=dev), retrain_every=RETRAIN_EVERY,
            train_keys=range(Q_BANK), per_key=True, controller=loss_ratio(**ADAPT_BANK))
        out[dev] = run(prng.key(3), batches, bcounts)
    (sg, pg, tg), (sc, pc, tc) = out["cuda"], out["cpu"]
    for f in ("x", "y"):
        check(torch.equal(sg.items[f].cpu(), sc.items[f]), f"ttbs bank items[{f}] card != CPU")
    for f in ("nfull", "weight", "total_weight", "pending", "overflow"):
        check(torch.equal(getattr(sg, f).cpu(), getattr(sc, f)), f"ttbs bank {f} card != CPU")
    for f in ("size", "overflow", "decay"):
        check(_leaves_equal(torch, tg[f].cpu(), tc[f]), f"ttbs bank trace {f} card != CPU")
    check(bool((tc["decay"] != tc["decay"][0]).any()), "[12] (d) the controllers never moved")
    print(f"[12] (d) ttbs bank at K = 4096, cap {4 * N_TTBS_BANK}, 8 ticks, per-key models and "
          f"controllers: card == CPU bit for bit (items, nfull, weight, W, pending, overflow, "
          f"sizes, the {Q_BANK} keys' decay); final buffers {int(sc.nfull.sum())} items")


# ---------------------------------------------------------------------------
# the LM online-management driver (ROADMAP A.8, A.9, A.11d): mamba2_370m at
# full size retrained with AdamW on its R-TBS sample, checkpoint/resume, the
# bank with telemetry, telemetry on the main cell
# --lr 3e-4: at 3e-3 (the driver's default, sized for the smoke configs)
# AdamW's first steps raise this model's eval loss (11.03 -> 11.25 over 16
# steps, PERF.md Sec. 6)
TRAIN_FLAGS = ["--arch", "mamba2_370m", "--preset", "full", "--seq-len", "512",
               "--batch-per-tick", "64", "--reservoir", "4096", "--retrain-every", "4",
               "--retrain-steps", "8", "--train-batch", "16", "--drift", "none",
               "--lr", "3e-4"]
# 8 ticks (two retrains), stopped at 4 and resumed to 8: cut from 12 / 8 to
# make room for phase 20 under the script's time limit
TRAIN_TICKS, TRAIN_STOP, TRAIN_LAM = 8, 4, 0.07
TRAIN_RESUME_LAYERS = 4        # (a)'s depth cut: its checkpoints 1 GB, not 4.4
# a profiled fit step's scopes: the backward's kernels run on autograd's
# device thread, outside the ``train.backward`` range of the calling thread,
# so it is read between ``train.forward`` and ``train.optim``
# (:func:`_between_ms`); the recompute's kernels land in its ``lm.*`` ranges
TRAIN_SCOPES = ("train.forward", "train.optim", "lm.embed", "lm.norm", "lm.qkv", "lm.rope",
                "lm.attn", "lm.attn_out", "lm.mlp", "lm.moe_route", "lm.moe_experts",
                "lm.moe_combine", "lm.ssm_in", "lm.conv", "lm.ssd", "lm.ssm_out",
                "lm.logits")
# one Mamba2 layer's parameter gradients through B5 (bf16 forward, the plain
# chunked form's backward) against the plain route's: each gradient's
# relative Frobenius distance, bounded by B5's bf16 tolerance
B5_GRAD_RTOL = 5e-2
# card vs CPU, one retrain of 2 AdamW steps at 2 layers of full width in f32:
# the step's losses, grad norms and the eval loss after it (f32 sums in two
# BLAS libraries' orders through two layers)
TRAIN_F32_RTOL = 1e-4
# ... and the params: an element whose two gradients are both below the
# sums' rounding can take AdamW's normalised step with the other sign, so
# the params are held as a share: at most 1e-3 of them beyond 1e-5, none
# beyond two such steps (2 x lr x lr_scale) + 1e-5
TRAIN_PARAM_ATOL, TRAIN_PARAM_SHARE = 1e-5, 1e-3


def _between_ms(torch, np, prof, after: str, before: str) -> tuple[float, int]:
    """(ms, kernels) of the device's kernels that start after the end of
    each device-side range of scope ``after`` and before the start of the
    next range of scope ``before``: in a train step, the backward's kernels
    between ``train.forward``'s and ``train.optim``'s. Autograd launches
    them from its own thread, outside the caller's ``train.backward`` range,
    so no device-side range of that scope holds them."""
    from torch.autograd import DeviceType

    starts, durs, spans = [], [], {after: [], before: []}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if e.is_user_annotation():
            if e.name() in spans:
                spans[e.name()].append((e.start_ns(), e.end_ns()))
        else:
            starts.append(e.start_ns())
            durs.append(e.duration_ns())
    starts, durs = np.asarray(starts, np.int64), np.asarray(durs, np.float64)
    nxt = sorted(a for a, _ in spans[before])
    inside = np.zeros(len(starts), bool)
    for _, end in sorted(spans[after]):
        j = np.searchsorted(nxt, end)
        if j < len(nxt):
            inside |= (starts >= end) & (starts < nxt[j])
    return float(durs[inside].sum()) / 1e6, int(inside.sum())


def _check_telemetry_file():
    """``benchmarks/check_telemetry.py``'s ``check_file``, loaded from its
    file (the script imports only the standard library)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "check_telemetry", HERE / "benchmarks" / "check_telemetry.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.check_file


def _b5_layer_grads(torch, cfg, p, u, w, plain: bool):
    """Gradients of sum(apply_ssm(u) * w) over u and one layer's SSM
    parameters, with B5 on its CUDA route or the plain chunked form."""
    from torch.utils import _pytree as pytree

    from repro_torch.kernels.ssd_scan import ops as ss_ops, ref as ss_ref
    from repro_torch.models import ssm as S

    leaves, spec = pytree.tree_flatten(p)
    live = [x.detach().requires_grad_(True) for x in leaves]
    ui = u.detach().requires_grad_(True)
    orig = ss_ops.ssd_scan
    if plain:
        ss_ops.ssd_scan = lambda x, dt, a, Bm, Cm, *, chunk, init_state=None: \
            ss_ref.ssd_chunked_ref(x, dt, a, Bm, Cm, chunk=chunk, init_state=init_state)
    try:
        out, _ = S.apply_ssm(cfg, pytree.tree_unflatten(live, spec), ui)
        return torch.autograd.grad((out.float() * w).sum(), [ui] + live)
    finally:
        ss_ops.ssd_scan = orig


def _train_state(torch, run, state=None):
    """A device copy of the driver's state (``run``'s or ``state``): model
    state, sampler state, controller state. A retrain updates the model
    state in place, so a replay starts from a copy."""
    from torch.utils import _pytree as pytree

    ms, st, cs = (run.model_state, run.st, run.cstate) if state is None else state
    return pytree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, (ms, st, cs))


def _resume_check(torch, np, train, flags, ticks, stop, tag, pdir=None) -> dict:
    """The driver at ``flags``: an unbroken run of ``ticks`` ticks
    (``LocalRun``), a run through ``main`` stopped at ``stop`` (a checkpoint
    there; with ``pdir``, a profiler trace of its first tick), and a run
    resumed from that checkpoint to ``ticks`` as ``main --resume`` resumes
    (``LocalRun.resume``): raise unless every tick's row and the resumed
    run's final state (params, AdamW moments and count, the reservoir) are
    bit for bit the unbroken run's. Seconds and sizes."""
    import shutil
    import tempfile

    from torch.utils import _pytree as pytree

    t0 = time.perf_counter()
    runu = train.LocalRun(train.parse_args(flags + ["--ticks", str(ticks)]))
    urows = [runu.tick(t) for t in range(ticks)]
    t1 = time.perf_counter()
    ck = tempfile.mkdtemp(prefix="ck_")
    try:
        extra = [] if pdir is None else ["--profile-dir", pdir, "--profile-ticks", "1"]
        first = train.main(flags + ["--ticks", str(stop), "--ckpt-dir", ck, "--ckpt-every",
                                    str(stop)] + extra)
        ck_gb = sum(f.stat().st_size for f in Path(ck).rglob("*") if f.is_file()) / 1e9
        t2 = time.perf_counter()
        runr = train.LocalRun(train.parse_args(flags + ["--ticks", str(ticks), "--ckpt-dir",
                                                        ck, "--resume"]))
        runr.resume()
        check(runr.start_tick == stop, f"{tag} resumed at tick {runr.start_tick}")
        resumed = [runr.tick(t) for t in range(stop, ticks)]
        t3 = time.perf_counter()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    for r in first + resumed:
        want = urows[r["tick"]]
        same = all(r[k] == want[k] or (math.isnan(r[k]) and math.isnan(want[k])) for k in want)
        check(set(r) == set(want) and same,
              f"{tag} tick {r['tick']}: resumed {r} != unbroken {want}")
    state = (runr.model_state, runr.st)
    check(_leaves_equal(torch, state, (runu.model_state, runu.st)),
          f"{tag} the resumed run's final state differs from the unbroken run's")
    leaves = pytree.tree_leaves(state)
    del runu, runr, state
    torch.cuda.empty_cache()
    return {"unbroken_s": t1 - t0, "first_s": t2 - t1, "resumed_s": t3 - t2,
            "leaves": len(leaves), "bytes": sum(x.numel() * x.element_size() for x in leaves),
            "ck_gb": ck_gb}


def phase_train(torch, np, kernels, timer, bw):
    """Phase 13: ``python -m repro_torch.launch.train``'s loop at
    mamba2_370m's full size under ``cfg.remat`` (the default): an unbroken
    run, a run stopped at tick TRAIN_STOP and resumed from its checkpoint
    (bit for bit), B1 and B5 counted a tick (B5's forward, recompute and
    eval launches apart), a profiled retrain tick, one layer's B5 gradient
    against the plain route's, B5 timed at the training shape, and (e) the
    last retrain tick again from its starting state with remat and without:
    bit for bit the same, both peaks and retrain times."""
    import dataclasses
    import shutil
    import tempfile

    from torch.utils import _pytree as pytree

    from repro_torch.kernels.ssd_scan import ops as ss_ops, ref as ss_ref
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    marks = {}
    args = train.parse_args(TRAIN_FLAGS + ["--ticks", str(TRAIN_TICKS)])
    run = train.LocalRun(args)
    cfg, L = run.cfg, run.cfg.num_layers
    nparam = sum(x.numel() for x in pytree.tree_leaves(run.model_state["params"]))
    print(f"[13] {' '.join(TRAIN_FLAGS)}: {L} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.padded_vocab}, {cfg.dtype} compute, {cfg.param_dtype} params and AdamW "
          f"moments ({nparam / 1e6:.1f} M params, {3 * 4 * nparam / 1e9:.2f} GB with m and v)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, walls, deltas, fit_s = [], [], [], []
    t_last = TRAIN_TICKS - 1            # a retrain tick ((t + 1) % 4 == 0)
    for t in range(TRAIN_TICKS):
        kernels.reset_launches()
        if t == t_last:                 # (e) replays this tick without remat from here
            snap = _train_state(torch, run)
            peak_before = torch.cuda.max_memory_allocated()
            base_on = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows.append(run.tick(t))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        deltas.append(dict(kernels.launches(), ssd_tc=ss_ops.ssd_scan.tensor_core_launches,
                           ssd_rec=ss_ops.ssd_scan.recompute_launches))
        if (t + 1) % args.retrain_every == 0:
            fit_s.append(run.last_fit_s)
    on = dict(peak=torch.cuda.max_memory_allocated() - base_on, fit_s=run.last_fit_s,
              b5=deltas[-1]["ssd_scan"], rec=deltas[-1]["ssd_rec"])
    peak_gb = max(peak_before, torch.cuda.max_memory_allocated()) / 1e9
    marks["unbroken run"] = time.perf_counter() - t_phase
    evals = [r["eval_loss"] for r in rows]
    ntok_fit = args.retrain_steps * args.train_batch * args.seq_len
    fast = [w for t, w in enumerate(walls) if (t + 1) % args.retrain_every]
    print(f"[13] eval loss by tick: {[round(e, 4) for e in evals]}")
    print(f"[13] W by tick (exact, W = e^-lam W + 64 in f32): "
          f"{[r['total_weight'] for r in rows]}; |S| {[r['sample_size'] for r in rows]}")
    steps = args.retrain_steps
    print(f"[13] launches a tick under remat: B1 1; B5 {L} a fast tick (the eval), "
          f"{L * (2 * steps + 2)} a retrain tick: {2 * L} evals (before and after the fit), "
          f"{steps * L} fit-step forwards and {steps * L} recomputes in their backwards "
          f"(each layer checkpointed), all tensor-core; "
          f"{sum(d['ssd_scan'] for d in deltas)} B5 launches in {TRAIN_TICKS} ticks, "
          f"{sum(d['ssd_rec'] for d in deltas)} of them recomputes")
    print(f"[13] {TRAIN_TICKS} ticks in {sum(walls):.3f} s = {TRAIN_TICKS / sum(walls):.3f} "
          f"ticks/s (fast ticks {1e3 * statistics.median(fast):.1f} ms median); seconds a "
          f"retrain (fit, {args.retrain_steps} AdamW steps) {[round(s, 4) for s in fit_s]}; "
          f"fit {ntok_fit / statistics.median(fit_s):.0f} tokens/s; peak memory "
          f"{peak_gb:.2f} GB")
    check(all(math.isfinite(e) for e in evals), f"eval losses {evals}")
    check(evals[-1] < evals[0], f"eval loss did not fall: {evals[0]} -> {evals[-1]}")
    _check_w(np, [r["total_weight"] for r in rows], [args.batch_per_tick] * TRAIN_TICKS,
             TRAIN_LAM)
    check(all(r["sample_size"] <= args.reservoir for r in rows), "|S| above --reservoir")
    for t, d in enumerate(deltas):
        fit = (t + 1) % args.retrain_every == 0
        want, rec = (L * (2 * steps + 2), L * steps) if fit else (L, 0)
        check(d["tbs_step_apply"] == 1, f"tick {t}: B1 launched {d['tbs_step_apply']} times")
        check(d["ssd_scan"] == d["ssd_tc"] == want and d["ssd_rec"] == rec,
              f"tick {t}: B5 launched {d['ssd_scan']} times ({d['ssd_tc']} tensor-core, "
              f"{d['ssd_rec']} in a backward), want {want} ({rec} recomputes): {L} a "
              f"forward (eval and the train loss), twice {L} a fit step (its forward and "
              f"its backward's recompute)")
        check(d["flash_attention"] == 0, f"tick {t}: B4 launched")

    # (a) at a depth cut of full width (its checkpoints 1 GB, not 4.4): an
    # unbroken run and a run stopped at TRAIN_STOP (a checkpoint there, a
    # profiler trace of its tick 0) and resumed: bit for bit the unbroken run
    pdir = tempfile.mkdtemp(prefix="prof_")
    try:
        t0 = time.perf_counter()
        rc = _resume_check(torch, np, train,
                           TRAIN_FLAGS + ["--layers", str(TRAIN_RESUME_LAYERS)],
                           TRAIN_TICKS, TRAIN_STOP, "[13] (a)", pdir)
        traces = list(Path(pdir).glob("trace_*.json"))
        check(len(traces) == 1 and traces[0].stat().st_size > 0, f"profile traces {traces}")
        marks["stop, resume, compare"] = time.perf_counter() - t0
        print(f"[13] (a) at {TRAIN_RESUME_LAYERS} of {L} layers: unbroken {TRAIN_TICKS} ticks "
              f"({rc['unbroken_s']:.2f} s); stopped at tick {TRAIN_STOP} ({rc['first_s']:.2f} s, "
              f"a checkpoint at {TRAIN_STOP}, a profiler trace of tick 0: {traces[0].name}, "
              f"{traces[0].stat().st_size / 1e6:.1f} MB), resumed to {TRAIN_TICKS} "
              f"({rc['resumed_s']:.2f} s with the restore): eval and train losses, W and |S| "
              f"of every tick equal to the unbroken run's bit for bit, and the final state's "
              f"{rc['leaves']} leaves ({rc['bytes'] / 1e9:.3f} GB: params, m, v, count, the "
              f"reservoir) bit for bit; the checkpoint on disk {rc['ck_gb']:.2f} GB")
    finally:
        shutil.rmtree(pdir, ignore_errors=True)

    # (b) one layer's gradients through B5 against the plain route's, at the
    # fit's shape (16 x 512), from the trained layer
    g = torch.Generator(device="cuda").manual_seed(13)
    p0 = run.model_state["params"]["blocks"][0]["ssm"]
    u = (torch.randn((args.train_batch, args.seq_len, cfg.d_model), generator=g,
                     device="cuda") * 0.5).to(torch.bfloat16)
    w = torch.randn((args.train_batch, args.seq_len, cfg.d_model), generator=g, device="cuda")
    n0 = ss_ops.ssd_scan.tensor_core_launches
    gk = _b5_layer_grads(torch, cfg, p0, u, w, plain=False)
    check(ss_ops.ssd_scan.tensor_core_launches == n0 + 1, "the kernel route missed B5")
    gp = _b5_layer_grads(torch, cfg, p0, u, w, plain=True)
    check(ss_ops.ssd_scan.tensor_core_launches == n0 + 1, "the plain route launched B5")
    names = ["u"] + [pytree.keystr(k) for k, _ in pytree.tree_flatten_with_path(p0)[0]]
    rels = {}
    for nm, a, b in zip(names, gk, gp):
        rels[nm] = float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
        check(torch.isfinite(a).all() and rels[nm] <= B5_GRAD_RTOL,
              f"layer gradient {nm}: relative distance {rels[nm]} > {B5_GRAD_RTOL}")
    print(f"[13] (b) one layer's gradients (u and {len(names) - 1} params) of "
          f"sum(apply_ssm(u) w) at [{args.train_batch}, {args.seq_len}, {cfg.d_model}] bf16, "
          f"B5 forward + plain backward vs the plain route: relative distances "
          f"{ {k: float(f'{v:.3g}') for k, v in rels.items()} } <= {B5_GRAD_RTOL}")
    del gk, gp, u, w

    # (c) B5 alone at the fit's shape (the conv output's strides, mamba2's
    # statistics), beside its bound and its plain version
    H, P, G, N, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_chunk
    x, dt, a, Bm, Cm = _b5_operands(torch, args.train_batch, args.seq_len, H, G, N, P,
                                    torch.bfloat16, g, strided=True, model=True)
    b5_ms = timer(lambda: ss_ops.ssd_scan(x, dt, a, Bm, Cm, chunk=Q), 10)
    plain_ms = timer(lambda: ss_ref.ssd_scan_ref(x, dt, a, Bm, Cm, chunk=Q), 5)
    gy = torch.ones_like(x)
    b5_bwd_ms = timer(lambda: ss_ops.ssd_scan_backward(
        x, dt, a, Bm, Cm, None, min(Q, args.seq_len), gy, None), 3)
    bound, by, flops, nbytes = _b5_bound_ms(x, Bm, min(Q, args.seq_len), bw)
    y, _ = ss_ops.ssd_scan(x, dt, a, Bm, Cm, chunk=Q)
    want, _ = ss_ref.ssd_scan_ref(x, dt, a, Bm, Cm, chunk=Q)
    err = _b5_close(torch, y, want, 5e-2, "B5 at the fit's shape")
    print(f"[13] (c) B5 at the fit's shape x bf16 [{args.train_batch}, {args.seq_len}, {H}, "
          f"{P}], B/C [{args.train_batch}, {args.seq_len}, {G}, {N}], Q {Q}: kernel "
          f"{b5_ms:.4f} ms, bound {bound:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB) = {b5_ms / bound:.2f}x; plain {plain_ms:.3f} ms; its "
          f"backward (the plain form's gradient) {b5_bwd_ms:.3f} ms; max |err| {err:.3g}")
    del x, dt, a, Bm, Cm, y, want, gy

    # (e) the last retrain tick (its turn with remat, the default, timed and
    # its peak taken in the run above) again from the state it started from
    # without remat: the losses, params and AdamW moments bit for bit the
    # run's; each turn's peak above what the card held when the tick began
    # (without remat the snapshot and the run's final state, 8.8 GB, are held
    # too, and not counted), its retrain time, B5's launches by kind
    t0 = time.perf_counter()
    final, adapter = run.model_state, run.adapter
    _, _, adapter_off = train.build_model(args, run.dev,
                                          cfg=dataclasses.replace(cfg, remat=False))
    run.model_state, run.st, run.cstate = _train_state(torch, run, snap)
    run.adapter = adapter_off
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_off = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    row = run.tick(t_last)
    torch.cuda.synchronize()
    off = dict(peak=torch.cuda.max_memory_allocated() - base_off, fit_s=run.last_fit_s,
               b5=ss_ops.ssd_scan.launches, rec=ss_ops.ssd_scan.recompute_launches)
    check(_leaves_equal(torch, run.model_state, final) and all(
              row[k] == rows[-1][k] for k in ("eval_loss", "train_loss", "total_weight")),
          "[13] (e) the retrain tick without remat: losses, params or moments differ from "
          "the run's with remat")
    evals = 2 * L
    for name, tr, rec in (("remat", on, steps * L), ("no remat", off, 0)):
        check(tr["rec"] == rec and tr["b5"] == evals + steps * L + rec,
              f"[13] (e) {name}: B5 launched {tr['b5']} times ({tr['rec']} recomputes)")
    check(on["peak"] < off["peak"], f"[13] (e) the remat peak {on['peak']} is not below "
                                    f"the peak without remat {off['peak']}")
    print(f"[13] (e) tick {t_last} (a retrain) with remat (the run's) and again from its "
          f"starting state without: eval {rows[-1]['eval_loss']:.6f}, train loss "
          f"{rows[-1]['train_loss']:.6f}, params and AdamW moments bit for bit; peak above "
          f"the tick's start {on['peak'] / 1e9:.2f} GB with remat vs {off['peak'] / 1e9:.2f} "
          f"GB without (max_memory_allocated); retrain {on['fit_s']:.3f} s vs "
          f"{off['fit_s']:.3f} s; B5 launches with remat {on['b5']} = {evals} eval + "
          f"{steps * L} fit forwards + {on['rec']} recomputes, without {off['b5']} = "
          f"{evals} eval + {steps * L} fit forwards; {time.perf_counter() - t0:.1f} s")
    del snap, final, adapter_off
    marks["(e) remat pair"] = time.perf_counter() - t0

    # one more fit step, profiled by scope (a retrain tick holds
    # retrain_steps of them and two evals: profiling all of it took 36 s of
    # host time)
    t0 = time.perf_counter()
    run.adapter = adapter
    prof_res = _profile_fit_step(torch, np, run, args, "[13]")
    marks["profiled fit step"] = time.perf_counter() - t0
    res = dict(rows=rows, peak_gb=peak_gb, fit_s=fit_s, prof=prof_res,
               remat_pair={"peak_gb": on["peak"] / 1e9, "no_remat_peak_gb": off["peak"] / 1e9,
                           "fit_s": on["fit_s"], "no_remat_fit_s": off["fit_s"],
                           "b5": on["b5"], "b5_recompute": on["rec"], "no_remat_b5": off["b5"]},
               b5_train=dict(ms=b5_ms, bound_ms=bound, bound_by=by, plain_ms=plain_ms,
                             backward_ms=b5_bwd_ms, max_abs_err=err,
                             launches=sum(d["ssd_scan"] for d in deltas),
                             recompute_launches=sum(d["ssd_rec"] for d in deltas),
                             shape=[args.train_batch, args.seq_len, H, P]),
               b1_launches=sum(d["tbs_step_apply"] for d in deltas))
    del run
    torch.cuda.empty_cache()
    print(f"[13] phase wall time {time.perf_counter() - t_phase:.1f} s: "
          f"{ {k: round(v, 1) for k, v in marks.items()} }")
    return res


def phase_train_parity(torch, np):
    """Phase 13 (d): one retrain (2 AdamW steps) at a depth cut of full width
    in f32 from the same params and rows, on the card and on the CPU, for
    mamba2_370m (2 layers) and stablelm_12b (1 layer)."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch import convert
    from repro_torch.config import get_config
    from repro_torch.core.api import SampleView
    from repro_torch.manage import make_sgd_adapter
    from repro_torch.models import zoo
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import sorted_tree
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    rows_n, seq, tb, steps, lr = 8, 64, 2, 2, 3e-3
    # stablelm_12b at 1 layer: its CPU side (1.3 B params with the embeddings)
    # is most of the phase
    for arch, layers in (("mamba2_370m", 2), ("stablelm_12b", 1)):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype="float32")
        api = zoo.build(cfg)
        tree = convert.lm_params_to_numpy(api.init_params(5))
        rng = np.random.default_rng(6)
        items = rng.integers(0, cfg.vocab_size, (rows_n, seq), dtype=np.int32)
        picks = rng.integers(0, rows_n, (steps, tb))
        held = rng.integers(0, cfg.vocab_size, (2, seq), dtype=np.int32)
        out, metrics = {}, {}
        for dev in ("cuda", "cpu"):
            p = convert.lm_params_from_numpy(cfg, tree, device=dev)
            step = make_train_step(api, AdamWConfig(lr=lr), warmup=2, total_steps=4000)
            ms = []

            def recording(params, opt, batch, _step=step, _ms=ms):
                params, opt, m = _step(params, opt, batch)
                _ms.append((float(m["loss"]), float(m["grad_norm"])))
                return params, opt, m

            ad = make_sgd_adapter(init_params=lambda: p, train_step=recording,
                                  init_opt_state=adamw_init, loss=api.loss,
                                  batch_field="tokens", train_batch=tb, retrain_steps=steps,
                                  device=dev)
            view = SampleView(items=torch.from_numpy(items).to(dev),
                              mask=torch.ones(rows_n, dtype=torch.bool, device=dev),
                              size=torch.tensor(rows_n, device=dev))
            st = ad.fit(None, ad.init(), view, rows=torch.from_numpy(picks).to(dev))
            ev = float(ad.evaluate(st, torch.from_numpy(held).to(dev), 2))
            out[dev] = [x.cpu() for x in pytree.tree_leaves(sorted_tree(st["params"]))]
            metrics[dev] = (ms, ev)
            del p, st, ad, view
        (mg, eg), (mc, ec) = metrics["cuda"], metrics["cpu"]
        for (lg, ng), (lc, nc) in zip(mg, mc):
            check(abs(lg - lc) <= TRAIN_F32_RTOL * abs(lc) and
                  abs(ng - nc) <= TRAIN_F32_RTOL * abs(nc),
                  f"{arch}: step loss / grad norm card {lg}, {ng} vs CPU {lc}, {nc}")
        check(abs(eg - ec) <= TRAIN_F32_RTOL * abs(ec), f"{arch}: eval card {eg} vs CPU {ec}")
        lr_eff = lr * float(cosine_schedule(1, warmup=2, total=4000))
        n = beyond = 0
        worst = 0.0
        for a, b in zip(out["cuda"], out["cpu"]):
            d = (a - b).abs()
            n += d.numel()
            beyond += int((d > TRAIN_PARAM_ATOL).sum())
            worst = max(worst, float(d.max()))
        check(beyond <= TRAIN_PARAM_SHARE * n and worst <= 2 * lr_eff + TRAIN_PARAM_ATOL,
              f"{arch}: {beyond} of {n} params beyond {TRAIN_PARAM_ATOL}, worst {worst}")
        print(f"[13] (d) {arch} at {layers} layers of full width, f32, one retrain of {steps} "
              f"AdamW steps on {tb} x {seq} rows, card vs CPU: step losses "
              f"{[round(x[0], 6) for x in mg]} (CPU {[round(x[0], 6) for x in mc]}), grad "
              f"norms within {TRAIN_F32_RTOL}, eval after {eg:.6f} vs {ec:.6f}; params: "
              f"{beyond} of {n} beyond {TRAIN_PARAM_ATOL} (<= {TRAIN_PARAM_SHARE} of them), "
              f"worst {worst:.3g} <= 2 lr_eff + {TRAIN_PARAM_ATOL} = "
              f"{2 * lr_eff + TRAIN_PARAM_ATOL:.3g}; {time.perf_counter() - t0:.1f} s")
        del out, tree
        torch.cuda.empty_cache()
    print(f"[13] (d) phase wall time {time.perf_counter() - t_phase:.1f} s")


BANK_TRAIN_FLAGS = ["--arch", "mamba2_370m", "--preset", "full", "--layers", "4",
                    "--seq-len", "128", "--batch-per-tick", "256", "--reservoir", "64",
                    "--num-keys", "16384", "--bank-bcap", "32", "--train-keys", "8",
                    "--ticks", "8", "--retrain-every", "4", "--retrain-steps", "2",
                    "--train-batch", "16"]


def phase_bank_train(torch, np, kernels):
    """Phase 14: the driver's bank mode (``--num-keys``) with R-TBS on the
    Mamba2 LM at a depth cut, with and without telemetry."""
    import tempfile

    from repro_torch.launch import train

    t_phase = time.perf_counter()
    check_file = _check_telemetry_file()
    logs, launches = [], []
    with tempfile.TemporaryDirectory() as tel:
        for extra in ([], ["--telemetry-dir", tel, "--telemetry-every", "4"]):
            kernels.reset_launches()
            t0 = time.perf_counter()
            logs.append(train.main(BANK_TRAIN_FLAGS + extra))
            torch.cuda.synchronize()
            launches.append((kernels.launches(), time.perf_counter() - t0))
        path = Path(tel) / "telemetry.jsonl"
        errs = check_file(path)
        recs = [json.loads(x) for x in path.read_text().splitlines()]
    T = len(logs[0])
    check(logs[0] == logs[1], "the bank run with telemetry differs from the run without")
    for lc, _ in launches:
        check(lc["tbs_step_apply_banked"] == T, f"B3 launched {lc['tbs_step_apply_banked']} "
                                                f"times in {T} ticks")
    check(errs == [], f"telemetry schema: {errs}")
    ticks = [r for r in recs if r["kind"] == "tick"]
    check([r["t"] for r in ticks] == list(range(T)), "tick records")
    check([r["metric"] for r in ticks] == [r["eval_loss"] for r in logs[0]],
          "telemetry metric != the trace's eval loss")
    check(all(math.isfinite(r["eval_loss"]) for r in logs[0]), "bank eval loss")
    K = int(BANK_TRAIN_FLAGS[BANK_TRAIN_FLAGS.index("--num-keys") + 1])
    print(f"[14] bank mode {' '.join(BANK_TRAIN_FLAGS)}: K = {K} keys x 65 slots x 128 "
          f"tokens ({K * 65 * 128 * 4 / 1e9:.3f} GB of items); eval by tick "
          f"{[round(r['eval_loss'], 4) for r in logs[0]]}; top-8 |S| at the end "
          f"{logs[0][-1]['train_key_sizes']}; telemetry on == off bit for bit; B3 "
          f"{launches[0][0]['tbs_step_apply_banked']} launches in {T} ticks; runs "
          f"{launches[0][1]:.2f} s / {launches[1][1]:.2f} s (off / on); "
          f"{len(ticks)} tick records + {len(recs) - len(ticks)} others pass "
          f"check_telemetry.check_file; columns {sorted(ticks[0])}")
    print(f"[14] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches[0][0]


def phase_telemetry(torch, np, kernels):
    """Phase 15: telemetry on the main cell (phase 3's stream at cap 2^20)."""
    import tempfile

    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler
    from repro_torch.launch import serve
    from repro_torch.manage import make_model, make_run_loop
    from repro_torch.obs import make_telemetry

    t_phase = time.perf_counter()
    check_file = _check_telemetry_file()
    batches, bcounts, _ = _main_stream(torch, "[15]")
    sampler = make_sampler("rtbs", n=N_MAIN, lam=LAM)
    model = make_model("linreg", dim=2)
    key = prng.key(11)
    with tempfile.TemporaryDirectory() as d:
        tel = make_telemetry(d, every=16)
        t0 = time.perf_counter()
        off = make_run_loop(sampler, model, retrain_every=RETRAIN_EVERY)(key, batches, bcounts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        on = make_run_loop(sampler, model, retrain_every=RETRAIN_EVERY, telemetry=tel)(
            key, batches, bcounts)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(_leaves_equal(torch, off, on), "telemetry changed (state, params, trace)")
        tel.close()
        path = Path(d) / "telemetry.jsonl"
        errs = check_file(path)
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        ticks = [r for r in recs if r["kind"] == "tick"]
        T = int(bcounts.shape[0])
        check(errs == [] and [r["t"] for r in ticks] == list(range(T)),
              f"telemetry records: {errs}, ticks {[r['t'] for r in ticks]}")
        check([r["size"] for r in ticks] == off[2]["size"].tolist(), "size column")
        warns = [r for r in recs if r["kind"] == "warning"]
        print(f"[15] main cell ({T} ticks, cap {N_MAIN + 1}), telemetry every 16: "
              f"(state, params, trace) bit-identical to telemetry off; {len(ticks)} tick "
              f"records + run header + {len(warns)} warnings pass check_file; runs "
              f"{t1 - t0:.3f} s off, {t2 - t1:.3f} s on")

        # fast ticks with their drains, under set_sync_debug_mode("error")
        fast = {k: v[:8] for k, v in batches.items()}
        tel2 = make_telemetry(d, every=4, jsonl_name="fast.jsonl")
        loop = make_run_loop(sampler, model, retrain_every=10 ** 6, telemetry=tel2)
        loop(key, fast, bcounts[:8])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop(key, fast, bcounts[:8])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(tel2.ticks == 16 and tel2.drains == 4, f"fast-tick drains {tel2.drains}")
        # the rows' device cost: 8 fast ticks profiled, the obs.stats scope's kernels
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            loop(key, fast, bcounts[:8])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        br = _breakdown(torch, prof, 1e3 * wall, tag="[15]", scopes=("obs.stats",),
                        named=(), what="8 fast ticks with telemetry")
        nstats = br["obs.stats kernels"]
        print(f"[15] 8 fast ticks, no host sync (set_sync_debug_mode('error')), 2 drains of "
              f"4 rows; telemetry's device time {br['obs.stats'] / 8:.4f} ms and "
              f"{nstats / 8:.1f} kernels a tick (the obs.stats scope) of "
              f"{br['device_ms'] / 8:.4f} ms and {br['kernels'] / 8:.1f} kernels a tick")
        tel2.close()

        # a short serve run's query records
        tel3 = make_telemetry(d, jsonl_name="serve.jsonl", monitors=())
        toks = serve.main(["--arch", "stablelm_12b", "--prompts", "3", "--prompt-len", "16",
                           "--gen", "4"], telemetry=tel3)
        tel3.close()
        spath = Path(d) / "serve.jsonl"
        qs = [json.loads(x) for x in spath.read_text().splitlines()]
        queries = [q for q in qs if q["kind"] == "query"]
        check(check_file(spath) == [] and len(queries) == 3 and
              [q["tokens_served"] for q in queries] == [5, 10, 15],
              f"serve query records {queries}")
        print(f"[15] serve (stablelm smoke, 3 x 16 prompts, 4 generated): {len(queries)} query "
              f"records pass check_file; {queries[-1]}; tokens {toks.shape}")
    print(f"[15] phase wall time {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the paper's distributed schemes (ROADMAP A.7): S reservoir shards as a
# leading dimension of one card's state, through the sharded loops
# global n 2^20 over 8 shards of 2^18 slots (twice the mean share), the
# main cell's 65,536 arrivals a tick (8,192 a shard)
SH_S, SH_N, SH_CAP_S, SH_T = 8, 1 << 20, 1 << 18, 48
SH_FARM_T = 24                 # (e)'s farm: the first 24 ticks of its stream
SH_SCOPES = ("manage.eval", "manage.sampler_step", "drtbs.draws", "drtbs.tick_map",
             "drtbs.payload", "drtbs.partial", "manage.retrain", "manage.size")
H3_KERNELS = ("hypergeometric",)
# the sharded driver at phase 14's depth cut (4 layers of mamba2_370m)
SHARD_TRAIN_FLAGS = ["--arch", "mamba2_370m", "--preset", "full", "--layers", "4",
                     "--seq-len", "128", "--batch-per-tick", "256", "--reservoir", "4096",
                     "--scheme", "drtbs", "--shards", "8", "--retrain-every", "4",
                     "--retrain-steps", "2", "--train-batch", "16", "--ckpt-every", "4"]


def _drtbs_recurrence(np, sizes, n, lam):
    """D-R-TBS's C_t and W_t on the host in f32, as its tick composes them:
    W = d W + B rounded once; C follows the decay (or undershoot)
    downsample, the inserts and the overshoot downsample to n."""
    d, nf = np.float32(math.exp(-lam)), np.float32(n)
    W = C = np.float32(0.0)
    Cs, Ws = [], []
    for b in sizes:
        B = np.float32(b)
        w_dec = np.float32(d * W)
        w_new = _fma32(np, d, W, B)
        if W < nf:
            C1 = min(w_dec, C) if 0 < w_dec < C else min(C, max(w_dec, np.float32(0)))
            C2 = np.float32(C1 + B)
            C = nf if C2 > nf else C2
        elif w_new >= nf:
            C = nf
        else:
            C = np.float32(min(np.float32(w_new - B), C) + B)
        W = w_new
        Cs.append(C)
        Ws.append(W)
    return Cs, Ws


def _sharded_stream(torch, S, T, b, *, bcap=None, sizes=None, device=None, seed=0,
                    rank=None):
    from repro_torch.data.streams import LinRegStream
    from repro_torch.manage import materialize_stream, shard_stream

    batches, bcounts = materialize_stream(LinRegStream(seed=seed), T,
                                          batch_size=sizes or b, bcap=bcap, device=device)
    return shard_stream(batches, bcounts, S, device=device, rank=rank)


def phase_sharded(torch, np, kernels, timer, bw, rtbs_ticks_per_s):
    """Phase 16: D-R-TBS and D-T-TBS with the shards a leading dimension of
    one card's state, through the sharded loops and the driver."""
    import shutil
    import tempfile

    from torch.utils import _pytree as pytree

    from repro_torch.core import prng
    from repro_torch.core.api import make_sampler
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.manage import (init_sharded_state, item_proto, make_model,
                                    make_sharded_manage_step, make_sharded_resume_loop,
                                    make_sharded_run_farm, make_sharded_run_loop)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    S, T, b_s = SH_S, SH_T, BCAP_MAIN // SH_S
    batches, bcounts = _sharded_stream(torch, S, T, BCAP_MAIN)
    sizes = [BCAP_MAIN] * T
    mesh = make_data_mesh(S)
    sampler = make_sampler("drtbs", n=SH_N, lam=LAM, cap_s=SH_CAP_S)
    model = make_model("linreg", dim=2)
    key = prng.key(21)
    run = make_sharded_run_loop(sampler, model, mesh, retrain_every=RETRAIN_EVERY)
    run(key, pytree.tree_map(lambda a: a[:RETRAIN_EVERY], batches), bcounts[:RETRAIN_EVERY])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, params, trace = run(key, batches, bcounts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    nfit = sum((t + 1) % RETRAIN_EVERY == 0 for t in range(T))
    want = {"tbs_step_apply": T, "hypergeometric": 2 * S * T, "reservoir_compact": nfit,
            "binomial": 0, "swap_delete": 0, "tbs_step_apply_banked": 0}
    for k, v in want.items():
        check(launches[k] == v, f"[16] drtbs: {k} launched {launches[k]} times, not {v}")
    print(f"[16] (a) drtbs: n = {SH_N}, {S} shards of cap_s {SH_CAP_S} "
          f"({S * SH_CAP_S * 12 / 1e6:.1f} MB of items), {T} ticks of {BCAP_MAIN} arrivals "
          f"({b_s} a shard), lam {LAM}, retrain every {RETRAIN_EVERY}: {wall:.3f} s = "
          f"{T / wall:.2f} ticks/s (phase 3's R-TBS at n = {N_MAIN}: "
          f"{rtbs_ticks_per_s:.2f} ticks/s); launches {launches}")

    # the ticks by hand: W / C / sizes per tick, equal to the run
    tick = make_sharded_manage_step(sampler, model, mesh, retrain_every=RETRAIN_EVERY)
    st, p = init_sharded_state(sampler, S, item_proto(batches)), model.init()
    rows, sz = [], []
    for t in range(T):
        st, p, m = tick(key, t, st, p, pytree.tree_map(lambda a: a[t], batches), bcounts[t])
        rows.append(torch.stack([st.weight.double(), st.total_weight.double()]))
        sz.append(m["size"])
    check(_leaves_equal(torch, (st, p), (state, params)), "[16] (a) ticks by hand != the run")
    check(torch.equal(torch.stack(sz), trace["size"]), "[16] (a) sizes by hand != the run")
    rows = torch.stack(rows).cpu().numpy()                       # [T, 2, S]
    check((rows == rows[:, :, :1]).all(), "[16] (a) C / W not replicated over the shards")
    Cs, Ws = _drtbs_recurrence(np, sizes, SH_N, LAM)
    sizes_t = trace["size"].cpu().numpy()
    for t in range(T):
        check(np.float32(rows[t, 1, 0]) == Ws[t], f"[16] (a) tick {t}: W {rows[t, 1, 0]!r} "
                                                  f"!= {Ws[t]!r}")
        check(np.float32(rows[t, 0, 0]) == Cs[t], f"[16] (a) tick {t}: C {rows[t, 0, 0]!r} "
                                                  f"!= {Cs[t]!r}")
        lo = math.floor(Cs[t])
        check(lo <= sizes_t[t] <= lo + 1, f"[16] (a) tick {t}: |S| {sizes_t[t]} vs C {Cs[t]}")
    check(int(state.overflow.sum()) == 0, "[16] (a) overflow at the main cell")
    check(int(state.nfull.sum()) <= SH_N, "[16] (a) more full items than n")
    check(np.isfinite(trace["metric"].cpu().numpy()).all(), "[16] (a) metric")
    sat = next(t for t in range(T) if Ws[t] >= SH_N)
    print(f"[16] (a) W_t and C_t exact in f32 on all {T} ticks (saturated from tick {sat}), "
          f"|S_t| in {{floor C_t, floor C_t + 1}}, overflow 0; final nfull by shard "
          f"{state.nfull.tolist()} (sum {int(state.nfull.sum())}), C {Cs[-1]:.1f} W "
          f"{Ws[-1]:.1f}; metric first/last {float(trace['metric'][0]):.4f}/"
          f"{float(trace['metric'][-1]):.4f}")

    # a non-retrain tick with every host sync an error
    t_free = T
    check((t_free + 1) % RETRAIN_EVERY != 0, "[16] sync-check tick must not retrain")
    b_t = pytree.tree_map(lambda a: a[T - 1], batches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tick(key, t_free, state, params, b_t, bcounts[T - 1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(int(out[0].nfull.sum()) <= SH_N, "[16] sync-check tick")
    print("[16] (a) one non-retrain tick ran under set_sync_debug_mode('error'): no host sync")

    # one profiled retrain tick
    prof_t = 4 * RETRAIN_EVERY - 1
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tick(key, prof_t, state, params, b_t, bcounts[T - 1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof_res = _breakdown(torch, prof, wall_ms, tag="[16] (a)", scopes=SH_SCOPES,
                          named=(("B1 kernel", "tbs_step_apply_kernel"),
                                 ("H3 kernels", H3_KERNELS),
                                 ("B2 kernel", "reservoir_compact")))

    # (c) fused == per-tick (above) == resumed, split at tick 24
    resume = make_sharded_resume_loop(sampler, model, mesh, retrain_every=RETRAIN_EVERY)
    st, p = init_sharded_state(sampler, S, item_proto(batches)), model.init()
    traces = []
    for lo, hi in ((0, 24), (24, T)):
        st, p, tr = resume(key, st, p, pytree.tree_map(lambda a: a[lo:hi], batches),
                           bcounts[lo:hi], lo)
        traces.append(tr)
    check(_leaves_equal(torch, (st, p), (state, params)), "[16] (c) resumed != fused")
    check(_leaves_equal(torch, {k: torch.cat([tr[k] for tr in traces]) for k in trace}, trace),
          "[16] (c) resumed trace != fused")
    print("[16] (c) fused == per-tick == resumed at tick 24, bit for bit (state, params, "
          "metric, size)")
    del state, st, out
    torch.cuda.empty_cache()

    # (d) D-T-TBS on the same stream: n_s = n / S, b_s arrivals a shard
    n_s, cap_d = SH_N // S, 1 << 19
    dsampler = make_sampler("dttbs", n=n_s, lam=LAM, batch_size=float(b_s), cap=cap_d)
    drun = make_sharded_run_loop(dsampler, model, mesh, retrain_every=RETRAIN_EVERY)
    drun(key, pytree.tree_map(lambda a: a[:RETRAIN_EVERY], batches), bcounts[:RETRAIN_EVERY])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    dstate, _, dtrace = drun(key, batches, bcounts)
    torch.cuda.synchronize()
    dwall = time.perf_counter() - t0
    dlaunches = kernels.launches()
    for k, v in {"tbs_step_apply": T, "binomial": T, "reservoir_compact": nfit,
                 "hypergeometric": 0, "swap_delete": 0}.items():
        check(dlaunches[k] == v, f"[16] (d) dttbs: {k} launched {dlaunches[k]} times, not {v}")
    p_ = float(dsampler.hyper["p"])
    w = np.float32(0.0)
    for t in range(T):
        w = _fma32(np, np.float32(p_), w, np.float32(b_s))
    check((dstate.total_weight.cpu().numpy() == w).all(), "[16] (d) W per shard")
    check(int(dstate.overflow.sum()) == 0, "[16] (d) overflow")
    E = S * n_s * (1 - p_ ** T)
    got = float(dtrace["size"][-1])
    check(abs(got - E) <= 6 * math.sqrt(E) + 1, f"[16] (d) |S| {got} vs E {E:.1f}")
    print(f"[16] (d) dttbs: n_s {n_s}, q {dsampler.hyper['q']:.4f}, cap {cap_d} a shard: "
          f"{dwall:.3f} s = {T / dwall:.2f} ticks/s; launches {dlaunches}; W exact per shard "
          f"(one rounding), overflow 0, final |S| {int(got)} vs E {E:.1f}")
    del dstate, batches, bcounts
    torch.cuda.empty_cache()

    # (b) card == CPU bit for bit at S = 4, cap_s 4096, for both schemes
    psz = [256 if t < 24 else 32 for t in range(T)]
    for scheme, hyper in (("drtbs", dict(n=4095, lam=LAM, cap_s=4096)),
                          ("dttbs", dict(n=1024, lam=LAM, batch_size=64.0, cap=4096))):
        out = {}
        for dev in ("cuda", "cpu"):
            bt, bc = _sharded_stream(torch, 4, T, None, bcap=256, sizes=lambda t: psz[t],
                                     device=dev, seed=1)
            out[dev] = make_sharded_run_loop(
                make_sampler(scheme, **hyper, device=dev), make_model("linreg", dim=2,
                                                                      device=dev),
                make_data_mesh(4, device=dev), retrain_every=RETRAIN_EVERY)(prng.key(7), bt, bc)
        (sg, pg, tg), (sc, pc, tc) = out["cuda"], out["cpu"]
        check(_leaves_equal(torch, pytree.tree_map(lambda a: a.cpu(), sg), sc),
              f"[16] (b) {scheme}: state card != CPU")
        check(torch.equal(tg["size"].cpu(), tc["size"]), f"[16] (b) {scheme}: sizes")
        check(torch.allclose(tg["metric"].cpu(), tc["metric"], rtol=1e-4, atol=1e-5, equal_nan=True),
              f"[16] (b) {scheme}: metric beyond rtol 1e-4")
        check(torch.allclose(pg.cpu(), pc, rtol=1e-4, atol=1e-5), f"[16] (b) {scheme}: params")
        print(f"[16] (b) {scheme} at S = 4: card == CPU bit for bit (every state leaf, sizes "
              f"of {T} ticks); metric max |diff| "
              f"{float((tg['metric'].cpu() - tc['metric']).abs().nan_to_num().max()):.3g}, "
              f"params max |diff| {float((pg.cpu() - pc).abs().max()):.3g} (rtol 1e-4: f32 "
              f"sums in another order)")

    # (e) a sharded farm of 8 trials at cap_s 4096 (a size cut) over SH_FARM_T
    # ticks (a depth cut: each single run it is held to takes ~6 s at 48),
    # then the driver
    FT = SH_FARM_T
    bt, bc = _sharded_stream(torch, S, FT, None, bcap=256, sizes=lambda t: psz[t], seed=1)
    fs = make_sampler("drtbs", n=4095, lam=LAM, cap_s=4096)
    kernels.reset_launches()
    t0 = time.perf_counter()
    fstates, fparams, ftrace = make_sharded_run_farm(fs, model, mesh, retrain_every=RETRAIN_EVERY)(
        prng.key(3), 8, bt, bc)
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t0
    flaunch = kernels.launches()
    check(flaunch["tbs_step_apply"] == FT, "[16] (e) farm: B1 not once a tick for all trials")
    frun = make_sharded_run_loop(fs, model, mesh, retrain_every=RETRAIN_EVERY)
    for i, k in enumerate(prng.split(prng.key(3), 8)):
        s1, p1, t1 = frun(k, bt, bc)
        check(_leaves_equal(torch, (s1, p1, t1), pytree.tree_map(
            lambda a: a[i], (fstates, fparams, ftrace))), f"[16] (e) farm trial {i} != its run")
    print(f"[16] (e) farm of 8 trials x {S} shards x {FT} ticks at cap_s 4096: {fwall:.3f} s "
          f"({8 * FT / fwall:.2f} trial-ticks/s); B1 {flaunch['tbs_step_apply']} launches; "
          f"equal to the 8 single runs bit for bit")

    ck = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        full = train.main(SHARD_TRAIN_FLAGS + ["--ticks", "8", "--ckpt-dir", str(ck / "a")])
        torch.cuda.synchronize()
        twall = time.perf_counter() - t0
        tl = kernels.launches()
        train.main(SHARD_TRAIN_FLAGS + ["--ticks", "4", "--ckpt-dir", str(ck / "b")])
        resumed = train.main(SHARD_TRAIN_FLAGS + ["--ticks", "8", "--ckpt-dir", str(ck / "b"),
                                                  "--resume"])
        check(resumed == full[4:], "[16] (e) the resumed driver's log != the unbroken run's")
        fa = (ck / "a" / "step_8" / "leaves.npz").read_bytes()
        fb = (ck / "b" / "step_8" / "leaves.npz").read_bytes()
        check(fa == fb, "[16] (e) the resumed driver's checkpoint differs byte for byte")
        check(all(math.isfinite(r["eval_loss"]) for r in full), "[16] (e) driver eval")
        check(tl["tbs_step_apply"] == 8, "[16] (e) driver: B1 not once a tick")
        print(f"[16] (e) driver {' '.join(SHARD_TRAIN_FLAGS)}: 8 ticks in {twall:.2f} s, eval "
              f"{[round(r['eval_loss'], 4) for r in full]}, |S| "
              f"{[r['sample_size'] for r in full]}; B1 {tl['tbs_step_apply']}, B5 "
              f"{tl['ssd_scan']}, B2 {tl['reservoir_compact']}, H3 {tl['hypergeometric']} "
              f"launches; stopped at 4 and resumed to 8: log and step_8 checkpoint equal "
              f"byte for byte")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    print(f"[16] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "dttbs_launches": dlaunches, "ticks_per_s": T / wall,
            "profile": prof_res}


# ---------------------------------------------------------------------------
# the rest of the LM zoo (ROADMAP A.11b-c): MoE, vlm, hybrid and
# encoder-decoder served at full width in bf16 through B4 and B5
# (arch, depth cut or None, prompts, prompt tokens, expected B4 and B5
# launches a prefill); qwen2-vl's prompts are VLM_PATCHES patch embeddings
# and 1,792 tokens (2,048 positions), whisper's 1,500 stubbed frames and a
# 224-token prompt; mixtral is cut to 4 of its 56 layers at full width
# (20.8 GB of bf16 weights), its 8,192-token prompts twice its window, so
# decode runs the ring buffer
ZOO_GEN = 32
ZOO_CELLS = (("granite_moe_3b", None, 8, 2048, 32, 0),
             ("qwen2_vl_2b", None, 8, 2048, 28, 0),
             ("zamba2_2p7b", None, 8, 8192, 9, 54),
             ("whisper_large_v3", None, 8, 224, 64, 0),
             ("mixtral_8x22b", 4, 2, 8192, 4, 0))
_ZOO_SCOPES = ("lm.embed", "lm.norm", "lm.qkv", "lm.rope", "lm.attn", "lm.cross_attn",
               "lm.attn_out", "lm.mlp", "lm.moe_route", "lm.moe_experts", "lm.moe_combine",
               "lm.ssm_in", "lm.conv", "lm.ssd", "lm.ssm_out", "lm.logits")
# B4's plain version and f32 reference are held on whole rows in slices of
# at most this many score elements (the served S = 8,192 shapes' full
# scores would take 26-39 GB)
_B4_SLICE_SCORES = 1 << 30


def _zoo_batch(torch, zoo, cfg, gen, prompts, seq):
    """The cell's batch: ``make_demo_batch``'s, but qwen2-vl's prompts are
    ``zoo.VLM_PATCHES`` patch embeddings and ``seq - VLM_PATCHES`` tokens,
    as the JAX package's ``input_specs`` lays out a vlm prefill."""
    if cfg.family != "vlm":
        return zoo.make_demo_batch(cfg, gen, prompts, seq)
    n = zoo.VLM_PATCHES
    b = zoo.make_demo_batch(cfg, gen, prompts, seq - n)
    fe = torch.randn((prompts, n, cfg.d_model), generator=gen, device=gen.device) * 0.02
    return {"tokens": b["tokens"], "frontend_embeds": fe.to(getattr(torch, cfg.dtype))}


def _zoo_cfg(arch, layers, **kw):
    import dataclasses

    from repro_torch.config import get_config

    over = dict(attention_impl="pallas", param_dtype="bfloat16", **kw)
    if layers is not None:
        over["num_layers"] = layers
    return dataclasses.replace(get_config(arch), **over)


def _tensors_equal(torch, a, b) -> bool:
    """Two trees of caches (lists, tuples, dicts, KVCache / SSMCache
    dataclasses, tensors, host ints) equal bit for bit."""
    import dataclasses

    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and _tensors_equal(torch, vars(a), vars(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tensors_equal(torch, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tensors_equal(torch, x, y) for x, y in zip(a, b))
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def _zoo_serve(torch, np, kernels, bw, arch, layers, prompts, seq, n_b4, n_b5) -> dict:
    """(a) one cell: bf16 weights made on the card, a short warm-up, the
    measured ``serve_batch``, a profiled prefill and a second one equal to
    it bit for bit, with B4 (and B5) launched the expected number of times
    in each prefill, all on their tensor-core routes, and never in decode."""
    from torch.utils import _pytree as pytree

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ss_ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import zoo

    torch.cuda.empty_cache()
    cfg = _zoo_cfg(arch, layers)
    api = zoo.build(cfg)
    t0 = time.perf_counter()
    params = api.init_params(0)
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(params))
    cut = f" (cut to {layers} of {_zoo_cfg(arch, None).num_layers} layers)" if layers else ""
    print(f"[17] (a) {arch}: {cfg.family}, {cfg.num_layers} layers{cut}, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}; weights {w_bytes / 1e9:.3f} GB bf16, made on the card "
          f"in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    serve_batch(api, params, _zoo_batch(torch, zoo, cfg, gen, prompts, min(seq, 512)), 2)
    batch = _zoo_batch(torch, zoo, cfg, gen, prompts, seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    tc4, tc5 = fa_ops.flash_attention.tensor_core_launches, ss_ops.ssd_scan.tensor_core_launches
    res = serve_batch(api, params, batch, ZOO_GEN)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = kernels.launches()
    pre, dec = res.prefill_launches, res.decode_launches
    tc4 = fa_ops.flash_attention.tensor_core_launches - tc4
    tc5 = ss_ops.ssd_scan.tensor_core_launches - tc5
    step_ms = 1e3 * res.decode_s / ZOO_GEN
    print(f"[17] (a) {arch}: {prompts} x {seq} prompts, {ZOO_GEN} generated: prefill "
          f"{res.prefill_s:.3f} s = {prompts * seq / res.prefill_s:.0f} prompt tokens/s; "
          f"decode {step_ms:.2f} ms a step = {prompts * ZOO_GEN / res.decode_s:.1f} tokens/s "
          f"(byte bound {w_bytes / bw * 1e3:.2f} ms: the weights once); peak memory "
          f"{peak_gb:.2f} GB; launches: prefill B4 {pre['flash_attention']} (tensor cores "
          f"{tc4}), B5 {pre['ssd_scan']} (tensor cores {tc5}); decode {dec}")
    check(pre["flash_attention"] == n_b4, f"{arch}: B4 launched {pre['flash_attention']} "
                                          f"times in the prefill, not {n_b4}")
    check(pre["ssd_scan"] == n_b5, f"{arch}: B5 launched {pre['ssd_scan']} times in the "
                                   f"prefill, not {n_b5}")
    check(tc4 == n_b4 and tc5 == n_b5, f"{arch}: prefill launches missed the tensor cores")
    check(launches == dict.fromkeys(launches, 0) | {"flash_attention": n_b4, "ssd_scan": n_b5},
          f"{arch}: launches of the run {launches}")
    toks = res.tokens
    check(toks.shape == (prompts, ZOO_GEN + 1) and ((toks >= 0) & (toks < cfg.vocab_size)).all(),
          f"{arch}: tokens {toks.shape} outside [0, {cfg.vocab_size})")
    print(f"[17] (a) {arch}: first sequence {toks[0].tolist()}")

    # a profiled prefill, then a second one: equal bit for bit (the MoE
    # combine's ordered sum, the sort-based dispatch, B4 and B5 are
    # deterministic), each launching the kernels once more
    max_len = seq + ZOO_GEN + 1
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    named = (("B4 kernel", "flash_attention_tc_kernel"), ("B5 kernel", "ssd_scan_tc_kernel"))
    with torch.no_grad():
        n0 = kernels.launches()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            l1, c1 = api.prefill(params, batch, max_len)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        prof_res = _breakdown(torch, prof, wall, "[17]", _ZOO_SCOPES, named,
                              what=f"{arch} prefill")
        l2, c2 = api.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        n2 = kernels.launches()
    check(torch.isfinite(l1.float()).all().item(), f"{arch}: non-finite prefill logits")
    check(n2["flash_attention"] - n0["flash_attention"] == 2 * n_b4
          and n2["ssd_scan"] - n0["ssd_scan"] == 2 * n_b5, f"{arch}: launches of 2 prefills")
    check(torch.equal(l1, l2) and _tensors_equal(torch, c1, c2),
          f"{arch}: a second prefill differs from the first")
    print(f"[17] (a) {arch}: a second prefill equals the first bit for bit (logits and "
          f"every cache tensor)")
    del l1, l2, c1, c2, params, batch
    torch.cuda.empty_cache()
    return dict(arch=arch, layers=cfg.num_layers, prompts=prompts, seq=seq,
                weights_gb=w_bytes / 1e9, prefill_s=res.prefill_s, decode_ms=step_ms,
                peak_gb=peak_gb, b4=n_b4, b5=n_b5,
                prefill_device_ms=prof_res["device_ms"], b4_ms=prof_res["B4 kernel"],
                b5_ms=prof_res["B5 kernel"])


def _b4_served(torch, timer, bw, what, B, S, H, KV, hd, causal, window, g) -> dict:
    """(b) B4 at a served shape (bf16, the tensor cores): the kernel on the
    whole batch; its first and last prompt held, in slices of whole rows,
    against the plain version (2e-2) and each row against the f32
    reference (B4_BF16_ROW_REL); its time beside its bound, the plain
    version's and ``scaled_dot_product_attention``'s (its flash kernel; the
    window as a boolean mask over kv heads expanded to H, which its
    memory-efficient kernel takes)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

    bf = torch.bfloat16
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(bf)
    k = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(bf)
    v = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(bf)
    n0, t0 = fa_ops.flash_attention.launches, fa_ops.flash_attention.tensor_core_launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    check(fa_ops.flash_attention.launches == n0 + 1
          and fa_ops.flash_attention.tensor_core_launches == t0 + 1,
          f"B4 {what}: not launched on the tensor cores")
    G = H // KV
    kc = max(1, min(KV, _B4_SLICE_SCORES // (G * S * S)))
    err = rel = 0.0
    for b in sorted({0, B - 1}):
        for k0 in range(0, KV, kc):
            sl = (slice(b, b + 1), slice(None), slice(k0 * G, (k0 + kc) * G))
            ks = (slice(b, b + 1), slice(None), slice(k0, k0 + kc))
            want = fa_ref.attention_ref(q[sl], k[ks], v[ks], causal=causal, window=window)
            err = max(err, max_abs_err(torch, out[sl], want))
            del want
            want32 = fa_ref.attention_ref(q[sl].float(), k[ks].float(), v[ks].float(),
                                          causal=causal, window=window)
            rel = max(rel, _row_rel_err(torch, out[sl], want32))
            del want32
    check(err <= 2e-2, f"B4 {what}: |diff| {err} to its plain version > 2e-2")
    check(rel <= B4_BF16_ROW_REL, f"B4 {what}: a row is {rel} of its norm off the f32 "
                                  f"reference, > {B4_BF16_ROW_REL}")
    del out
    ms = timer(lambda: fa_ops.flash_attention(q, k, v, causal=causal, window=window), 10)
    pb = B if B * H * S * S <= _B4_SLICE_SCORES else 1     # the plain version's prompts
    plain_ms = timer(lambda: fa_ref.attention_ref(q[:pb], k[:pb], v[:pb], causal=causal,
                                                  window=window), 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.permute(0, 2, 1, 3)
    if window:
        kt, vt = (x.repeat_interleave(G, dim=2).permute(0, 2, 1, 3) for x in (k, v))
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        lib = lambda: sdpa(qt, kt, vt, attn_mask=mask)  # noqa: E731
    else:
        kt, vt = (x.permute(0, 2, 1, 3) for x in (k, v))
        lib = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)  # noqa: E731
    lib_ms = timer(lib, 10)
    bound, by, flops, nbytes = _b4_bound_ms(q, k, causal, window, bw)
    print(f"[17] (b) B4 {what} [B, S, H, KV, hd] = [{B}, {S}, {H}, {KV}, {hd}] bf16 "
          f"causal={causal} window={window}: prompts 0 and {B - 1} vs the plain version max "
          f"|diff| {err:.3g} <= 2e-2, rows vs the f32 reference {rel:.3g} of their norm <= "
          f"{B4_BF16_ROW_REL}; kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{ms / bound:.2f}x its bound, {ms / lib_ms:.2f}x scaled_dot_product_attention)  "
          f"plain {plain_ms:.3f} ms on {pb} prompt(s)  scaled_dot_product_attention "
          f"{lib_ms:.3f} ms  bound {bound:.4f} ms by {by}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(what=what, shape=[B, S, H, KV, hd], causal=causal, window=window, ms=ms,
                plain_ms=plain_ms, plain_prompts=pb, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, max_abs_err=err)


def _b5_served(torch, timer, bw, B, S, H, G, N, P, Q, g) -> dict:
    """(b) B5 at zamba2's served shape (bf16, the tensor cores, the conv
    output's views and the Mamba2 layer's statistics at init) against its
    plain version, its last prompt's rows against the f32 recurrence, and
    its time beside its bound and the plain version's."""
    from repro_torch.kernels.ssd_scan import ops as ss_ops, ref as ss_ref

    x, dt, a, Bm, Cm = _b5_operands(torch, B, S, H, G, N, P, torch.bfloat16, g,
                                    strided=True, model=True)
    n0, t0 = ss_ops.ssd_scan.launches, ss_ops.ssd_scan.tensor_core_launches
    y, st = ss_ops.ssd_scan(x, dt, a, Bm, Cm, chunk=Q)
    want_y, want_st = ss_ref.ssd_scan_ref(x, dt, a, Bm, Cm, chunk=Q)
    torch.cuda.synchronize()
    check(ss_ops.ssd_scan.launches == n0 + 1 and ss_ops.ssd_scan.tensor_core_launches == t0 + 1,
          "B5 at zamba2's shape: not launched on the tensor cores")
    what = f"zamba2 [B, S, H, G, N, P, Q] = [{B}, {S}, {H}, {G}, {N}, {P}, {Q}] bf16 strided"
    err = max(_b5_close(torch, y, want_y, B5_BF16_TOL, what),
              _b5_close(torch, st, want_st, B5_BF16_TOL, what + " state"))
    del want_y, want_st
    last = slice(B - 1, B)
    rel = _b5_rows(torch, y[last], x[last], dt[last], a, Bm[last], Cm[last], what)
    del y, st
    ms = timer(lambda: ss_ops.ssd_scan(x, dt, a, Bm, Cm, chunk=Q), 10)
    plain_ms = timer(lambda: ss_ref.ssd_scan_ref(x, dt, a, Bm, Cm, chunk=Q), 3)
    bound, by, flops, nbytes = _b5_bound_ms(x, Bm, Q, bw)
    print(f"[17] (b) B5 {what}: vs its plain version max |diff| {err:.3g} (atol = rtol = "
          f"{B5_BF16_TOL}); last prompt's rows vs the f32 recurrence {rel:.3g} of their norm "
          f"<= {B5_BF16_ROW_REL}; kernel {ms:.3f} ms ({nbytes / ms / 1e6:.1f} GB/s, "
          f"{ms / bound:.2f}x its bound)  plain {plain_ms:.3f} ms  bound {bound:.4f} ms by "
          f"{by}; no single PyTorch call computes this function")
    del x, dt, a, Bm, Cm
    torch.cuda.empty_cache()
    return dict(what="zamba2", shape=[B, S, H, G, N, P, Q], ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound, bound_by=by, max_abs_err=err)


def _zoo_parity(torch, np, kernels, arch, over, batch_np, n_b4, n_b5, split, note) -> None:
    """(c) one family at a depth cut of full width in f32 (bf16 weights cast
    to f32 at each use): the same params (through ``convert``) and batch on
    the card and the CPU, prefill logits within LM_F32_ATOL and the greedy
    tokens equal, B4 / B5 launched on the card only; then on the card the
    prefill of the first ``split`` tokens plus teacher-forced decode of the
    rest against the forward (within LM_F32_ATOL)."""
    from repro_torch import convert
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import zoo

    cfg = _zoo_cfg(arch, None, dtype="float32", **over)
    api = zoo.build(cfg)
    tree = convert.lm_params_to_numpy(api.init_params(2))
    params = {dev: convert.lm_params_from_numpy(cfg, tree, device=dev) for dev in ("cuda", "cpu")}
    del tree
    out = {}
    for dev, p in params.items():
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        kernels.reset_launches()
        with torch.no_grad():
            logits, _ = api.prefill(p, b, batch_np["tokens"].shape[1] + 9
                                    + (b["frontend_embeds"].shape[1]
                                       if cfg.family == "vlm" else 0))
        served = serve_batch(api, p, b, 8)
        n = kernels.launches()
        out[dev] = (logits.float().cpu(), served.tokens, n["flash_attention"], n["ssd_scan"])
    (lg, tg, g4, g5), (lc, tcpu, c4, c5) = out["cuda"], out["cpu"]
    check((g4, g5, c4, c5) == (2 * n_b4, 2 * n_b5, 0, 0),
          f"{arch} parity: launches card B4 {g4} B5 {g5}, CPU {c4} {c5}")
    dl = float((lg - lc).abs().max())
    check(dl <= LM_F32_ATOL, f"{arch}: prefill logits card vs CPU |diff| {dl} > {LM_F32_ATOL}")
    check(np.array_equal(tg, tcpu), f"{arch}: greedy tokens card {tg.tolist()} != CPU "
                                    f"{tcpu.tolist()}")
    print(f"[17] (c) {arch} {note}, f32: prefill logits card vs CPU max |diff| {dl:.3g} <= "
          f"{LM_F32_ATOL}; the 9 greedy tokens of every sequence equal: {tg[0].tolist()}")
    if cfg.num_experts:
        # the route of the first MoE layer on one input, card vs CPU
        from repro_torch.models import layers as L
        from repro_torch.models import moe as M

        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (1, 512, cfg.d_model), dtype=np.float32))
        routes = []
        for dev, p in params.items():
            blk = p["blocks"][0]
            with torch.no_grad():
                routes.append(M.route(cfg, blk["moe"], L.apply_norm(cfg, blk["ln2"], x.to(dev))))
        rg, rc = routes
        for f in ("eidx", "order", "dest", "keep"):
            check(torch.equal(getattr(rg, f).cpu(), getattr(rc, f)),
                  f"{arch}: route {f} card != CPU")
        dg = float((rg.gates.cpu() - rc.gates).abs().max())
        print(f"[17] (c) {arch}: layer 0's route of 512 tokens card == CPU (eidx, order, "
              f"dest, keep bit for bit; {int(rc.keep.sum())} of {rc.keep.numel()} "
              f"assignments kept; gates max |diff| {dg:.3g})")
    del params["cpu"]
    p = params["cuda"]
    b = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    toks = b["tokens"]
    with torch.no_grad():
        full = api.forward(p, b).float()
        lp, caches = api.prefill(p, dict(b, tokens=toks[:, :split]), toks.shape[1] + 1
                                 + (b["frontend_embeds"].shape[1] if cfg.family == "vlm" else 0))
        steps = [lp[:, 0].float()]
        for t in range(split, toks.shape[1]):
            lt, caches = api.decode_step(p, caches, toks[:, t:t + 1])
            steps.append(lt[:, 0].float())
    dec = torch.stack(steps, dim=1)
    dd = float((full[:, full.shape[1] - dec.shape[1]:] - dec).abs().max())
    check(dd <= LM_F32_ATOL, f"{arch}: teacher-forced decode vs forward |diff| {dd} > "
                             f"{LM_F32_ATOL}")
    print(f"[17] (c) {arch}: prefill of {split} tokens + {toks.shape[1] - split} "
          f"teacher-forced decode steps vs the forward: max |diff| {dd:.3g} <= {LM_F32_ATOL}")
    del p, params, caches
    torch.cuda.empty_cache()


def phase_zoo(torch, np, kernels, timer, bw) -> dict:
    """Phase 17: the MoE, vlm, hybrid and encoder-decoder families served at
    full width in bf16 (a), B4 and B5 at their new served shapes (b), and
    card == CPU per family in f32 (c)."""
    cells = [_zoo_serve(torch, np, kernels, bw, *c) for c in ZOO_CELLS]

    g = torch.Generator(device="cuda").manual_seed(17)
    b4 = [_b4_served(torch, timer, bw, "granite_moe_3b", 8, 2048, 24, 8, 64, True, 0, g),
          _b4_served(torch, timer, bw, "qwen2_vl_2b", 8, 2048, 12, 2, 128, True, 0, g),
          _b4_served(torch, timer, bw, "zamba2_2p7b", 8, 8192, 32, 32, 80, True, 0, g),
          _b4_served(torch, timer, bw, "whisper encoder", 8, 1500, 20, 20, 64, False, 0, g),
          _b4_served(torch, timer, bw, "whisper decoder", 8, 224, 20, 20, 64, True, 0, g),
          _b4_served(torch, timer, bw, "mixtral_8x22b", 2, 8192, 48, 8, 128, True, 4096, g)]
    # the f32 route (the CUDA-core kernel) at the head dims (c) runs in f32
    f32 = [_b4_equal(torch, 1, 512, 8, 8, 80, torch.float32, True, 0, 2e-5, g, tag="[17]"),
           _b4_equal(torch, 2, 1500, 4, 4, 64, torch.float32, False, 0, 2e-5, g, tag="[17]")]
    b5 = _b5_served(torch, timer, bw, 8, 8192, 80, 1, 64, 64, 256, g)

    rng = np.random.default_rng(3)
    toks = lambda n, vocab: rng.integers(0, vocab, (2, n))  # noqa: E731
    frames = lambda n, d: (rng.standard_normal((2, n, d)) * 0.02).astype(np.float32)  # noqa: E731
    # MoE at a capacity (E / K) that drops nothing, so the forward over
    # 2 x 256 tokens and one-token decode steps route alike
    _zoo_parity(torch, np, kernels, "granite_moe_3b", dict(num_layers=2, moe_capacity_factor=5.0),
                {"tokens": toks(256, 49155)}, 2, 0, 192, "at 2 layers of full width")
    _zoo_parity(torch, np, kernels, "qwen2_vl_2b", dict(num_layers=2),
                {"tokens": toks(248, 151936), "frontend_embeds": frames(8, 1536)}, 2, 0, 192,
                "at 2 layers, 8 patches + 248 tokens")
    _zoo_parity(torch, np, kernels, "zamba2_2p7b", dict(num_layers=6),
                {"tokens": toks(512, 32000)}, 1, 6, 256,
                "at one group (6 Mamba2 layers + the shared block), 2 x 512 tokens")
    _zoo_parity(torch, np, kernels, "whisper_large_v3", dict(num_layers=2, encoder_layers=2),
                {"tokens": toks(64, 51866), "frontend_embeds": frames(1500, 1280)}, 4, 0, 32,
                "at 2 encoder + 2 decoder layers over 1,500 frames")
    return dict(cells=cells, b4=b4, b4_f32_err=max(f32), b5=b5)

# ---------------------------------------------------------------------------
# the key-sharded bank loop (ROADMAP A.7): phase 6's bank split by key
# ownership over KS_S shards of K_BANK / KS_S keys, one bank step a tick
# for all shards; compression and the examples
KS_S = 8
EXAMPLES = ("quickstart", "lm_online_management", "serve_batched", "distributed_reservoir")


def _keyed_parity_stream(torch, dev, S, K=4096):
    from repro_torch.data.streams import KeyedStream, LinRegStream
    from repro_torch.manage import materialize_stream, shard_keyed_stream

    batches, bcounts = materialize_stream(
        KeyedStream(LinRegStream(seed=1), num_keys=K, alpha=1.1, flip_every=50),
        8, batch_size=2048, fields=("key", "x", "y"), device=dev)
    return (batches, bcounts), shard_keyed_stream(batches, bcounts, S, K, device=dev)


def _run_examples() -> dict:
    """The four ``examples_torch/`` scripts as subprocesses at their default
    device (the card), all started together; each must exit 0."""
    import os
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    procs = {}
    t0 = time.perf_counter()
    for name in EXAMPLES:
        procs[name] = subprocess.Popen(
            [sys.executable, str(HERE / "examples_torch" / f"{name}.py")], cwd=HERE,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    walls = {}
    for name, p in procs.items():
        try:
            out, _ = p.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        walls[name] = time.perf_counter() - t0
        tail = out.strip().splitlines()[-2:]
        print(f"[18] (c) examples_torch/{name}.py exited {p.returncode} after "
              f"{walls[name]:.1f} s: {' | '.join(tail)}")
        check(p.returncode == 0, f"[18] (c) examples_torch/{name}.py exited {p.returncode}:"
                                 f"\n{out[-3000:]}")
    return walls


def phase_key_sharded(torch, np, kernels) -> dict:
    """Phase 18: the key-sharded bank loop at K = 2^20 over KS_S shards (a),
    its parities (b), gradient compression and the examples (c)."""
    from torch.utils import _pytree as pytree

    from repro_torch.bank import make_bank, shard_bank
    from repro_torch.config import get_config
    from repro_torch.core import prng
    from repro_torch.data.streams import KeyedStream, LinRegStream
    from repro_torch.kernels.swap_delete import ops as sd_ops
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.manage import (make_bank_run_loop, make_model, make_sharded_bank_loop,
                                    make_sharded_bank_manage_step, materialize_stream,
                                    shard_keyed_stream)
    from repro_torch.models import zoo
    from repro_torch.optim import compress_grads, ef_init

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    S, K, n, b, bcap, T, Q = KS_S, K_BANK, N_BANK, B_BANK, BCAP_BANK, T_BANK, Q_BANK
    K_s = K // S
    batches, bcounts = materialize_stream(
        KeyedStream(LinRegStream(seed=0), num_keys=K, alpha=1.1, flip_every=50), T,
        batch_size=b, fields=("key", "x", "y"))
    t0 = time.perf_counter()
    sb, sc = shard_keyed_stream(batches, bcounts, S, K)
    torch.cuda.synchronize()
    t_shard = time.perf_counter() - t0
    check(torch.equal(sc.sum(-1), bcounts), "[18] (a) the shards' arrivals != the stream's")
    bcap_s = sb["key"].shape[1] // S
    rows = int(sc.sum(-1).max())
    share = sc.double().mean(0) / b
    print(f"[18] (a) shard_keyed_stream: {T} ticks x {b} arrivals over K = {K} keys -> {S} "
          f"shards of K_s = {K_s} in {t_shard:.2f} s; bcap_s {bcap_s} (S x bcap_s = "
          f"{S * bcap_s} rows a tick); mean arrivals a tick by shard "
          f"{[round(float(x), 1) for x in sc.double().mean(0)]} (shares "
          f"{[round(100 * float(x), 2) for x in share]} %); rows routed a tick {rows} "
          f"(the tick's {b} arrivals; {S * bcap_s} if every row were routed)")

    model = make_model("linreg", dim=2)
    key = prng.key(0)
    local_bank = make_bank("rtbs", num_keys=K, n=n, lam=LAM_BANK, bcap=bcap)
    bank = make_bank("rtbs", num_keys=K_s, n=n, lam=LAM_BANK, bcap=bcap)
    mesh = make_data_mesh(S)
    local = make_bank_run_loop(local_bank, model, retrain_every=RETRAIN_EVERY,
                               train_keys=range(Q))
    sharded = make_sharded_bank_loop(bank, model, mesh, retrain_every=RETRAIN_EVERY,
                                     train_keys=range(Q))
    local(key, {f: v[:2] for f, v in batches.items()}, bcounts[:2])      # warm-up
    sharded(key, {f: v[:2] for f, v in sb.items()}, sc[:2])
    torch.cuda.synchronize()

    walls = {"local": [], "sharded": []}
    out, peak = {}, {}
    for which in ("local", "sharded", "sharded", "local"):       # paired turns
        kernels.reset_launches()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = (local(key, batches, bcounts) if which == "local" else sharded(key, sb, sc))
        torch.cuda.synchronize()
        walls[which].append(time.perf_counter() - t0)
        peak[which] = (torch.cuda.max_memory_allocated() - before) / 1e9   # the run's own
        if which not in out:
            out[which] = (res, kernels.launches(), sd_ops.swap_delete.forest_launches)
        del res
    (state, params, trace), launches, forest = out["sharded"]
    (_, _, ltrace), llaunch, _ = out["local"]
    tps = {k: [T / w for w in v] for k, v in walls.items()}
    check(launches["tbs_step_apply_banked"] == T,
          f"[18] (a) B3 launched {launches['tbs_step_apply_banked']} times, not once a tick")
    check(launches["swap_delete"] >= T and forest == 0, "[18] (a) H1 left its rows route")
    for k in ("tbs_step_apply", "reservoir_compact", "binomial", "hypergeometric"):
        check(launches[k] == 0, f"[18] (a) {k} launched on the key-sharded bank's path")
    sizes = trace["size"].cpu().numpy()
    metric = trace["metric"].cpu().numpy()
    check(state.items["x"].shape == (S, K_s, n + 1, 2), "[18] (a) state's shape")
    check(sizes.shape == (S, T, Q) and (sizes <= n).all(), "[18] (a) size > n")
    check(np.isfinite(metric[:, 1:]).all(), "[18] (a) metric not finite after tick 0")
    check((metric == metric[:1]).all(), "[18] (a) the metric rows differ across shards")
    check(torch.isfinite(params).all().item() and params.shape == (S, 3), "[18] (a) params")
    check(torch.equal(trace["overflow"].sum(0), ltrace["overflow"]),
          "[18] (a) the overflow summed over shards != phase 6's, tick by tick")
    print(f"[18] (a) key-sharded bank loop: {S} shards x K_s = {K_s} (K = {K}, n {n}, bcap "
          f"{bcap}, {state.items['x'].numel() * 4 / 1e6 + state.items['y'].numel() * 4 / 1e6:.1f}"
          f" MB of items), {T} ticks, train keys range({Q}) on every shard; paired turns "
          f"local, sharded, sharded, local: sharded {[round(x, 2) for x in tps['sharded']]} "
          f"ticks/s = {[round(T * b / w) for w in walls['sharded']]} keyed items/s, phase "
          f"6's local bank {[round(x, 2) for x in tps['local']]} ticks/s = "
          f"{[round(T * b / w) for w in walls['local']]} keyed items/s; peak memory of a run "
          f"(above what it found allocated) sharded {peak['sharded']:.3f} GB, local "
          f"{peak['local']:.3f} GB; launches {launches} (local: {llaunch})")
    print(f"[18] (a) B3 once a tick for all {S} shards, H1 on its rows route; sizes <= {n}; "
          f"metric finite from tick 1 and equal on every shard (first/last "
          f"{metric[0, 0]:.4f}/{metric[0, -1]:.4f}); overflow summed over shards == phase "
          f"6's on every tick ({trace['overflow'].sum(0).tolist()[:4]}...); each tick's "
          f"arrivals over the shards == the stream's bcounts")

    # one retrain tick profiled, one non-retrain tick under sync debug, and
    # one step's routed rows accounted, on the run's final state
    tick = make_sharded_bank_manage_step(bank, model, mesh, retrain_every=RETRAIN_EVERY,
                                         train_keys=range(Q), rows=rows)
    bt = {f: v[T - 1] for f, v in sb.items()}
    prof_t = 4 * RETRAIN_EVERY - 1
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, params, _ = tick(key, prof_t, state, params, bt, sc[T - 1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    profile = _breakdown(torch, prof, wall_ms, "[18] (a)", _BANK_SCOPES,
                         (("B3 kernel", "tbs_step_banked_kernel"), ("H1 kernels", H1_KERNELS)))
    check((T + 1) % RETRAIN_EVERY != 0, "[18] sync-check tick must not retrain")
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, params, _ = tick(key, T, state, params, bt, sc[T - 1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(kernels.launches()["tbs_step_apply_banked"] == 1, "[18] sync-check tick: B3")
    sbank = shard_bank(bank, S)
    state, st = sbank.step_stats(key, state, bt["key"], {"x": bt["x"], "y": bt["y"]},
                                 sc[T - 1], rows=rows)
    r = st["routing"]
    routed = int(r.counts.sum() + r.dropped.sum() + st["invalid"].sum())
    check(routed == int(bcounts[T - 1]), f"[18] (a) routed {routed} != {int(bcounts[T - 1])}")
    check(torch.equal(st["ntouched"].sum(), r.ntouched), "[18] (a) ntouched by shard")
    print(f"[18] (a) a non-retrain tick under set_sync_debug_mode('error'): no host sync; one "
          f"step routes {r.order.shape[0]} rows: {int(r.counts.sum())} accepted + "
          f"{int(r.dropped.sum())} dropped + {int(st['invalid'].sum())} invalid = the tick's "
          f"{int(bcounts[T - 1])}; touched keys by shard {st['ntouched'].tolist()}")
    del state, params, st, r, out, batches, sb
    torch.cuda.empty_cache()

    # (b) card == CPU at K = 4096 over 4 shards, both banks, shared and per key
    hyp = {"rtbs": dict(n=n, lam=LAM_BANK, bcap=bcap),
           "ttbs": dict(n=N_TTBS_BANK, lam=LAM_BANK, bcap=bcap, batch_size=2.0)}
    streams = {dev: _keyed_parity_stream(torch, dev, 4) for dev in ("cuda", "cpu")}
    diffs = []
    for scheme in ("rtbs", "ttbs"):
        for per_key in (False, True):
            res = {}
            for dev in ("cuda", "cpu"):
                _, (pb, pc) = streams[dev]
                res[dev] = make_sharded_bank_loop(
                    make_bank(scheme, num_keys=1024, **hyp[scheme], device=dev),
                    make_model("linreg", dim=2, device=dev), make_data_mesh(4, device=dev),
                    retrain_every=RETRAIN_EVERY, train_keys=range(Q),
                    per_key=per_key)(prng.key(3), pb, pc)
            (sg, pg, tg), (s_c, pc_, tc) = res["cuda"], res["cpu"]
            what = f"[18] (b) {scheme} {'per key' if per_key else 'shared'}"
            check(_leaves_equal(torch, pytree.tree_map(lambda a: a.cpu(), sg), s_c),
                  f"{what}: state card != CPU")
            for f in ("size", "overflow"):
                check(torch.equal(tg[f].cpu(), tc[f]), f"{what}: trace {f} card != CPU")
            same = (_leaves_equal(torch, pg.cpu(), pc_)
                    and _leaves_equal(torch, tg["metric"].cpu(), tc["metric"]))
            check(torch.equal(tg["metric"].isnan().cpu(), tc["metric"].isnan()),
                  f"{what}: the metric's NaNs")
            dm = float((tg["metric"].cpu() - tc["metric"]).abs().nan_to_num().max())
            dp = float((pg.cpu() - pc_).abs().nan_to_num().max())
            # f32 sums in two BLAS libraries' orders: the shared fit on the pooled
            # extract, and per key shard 0's fits (its train keys hold 7 or more
            # items at every retrain; shards 1-3's mostly 0-2, underdetermined)
            held = slice(None) if not per_key else slice(0, 1)
            check(torch.allclose(pg[held].cpu(), pc_[held], rtol=1e-4, atol=1e-5)
                  and torch.allclose(tg["metric"][held].cpu(), tc["metric"][held], rtol=1e-4,
                                     atol=1e-5, equal_nan=True),
                  f"{what}: params / metric beyond 1e-4")
            diffs.append((scheme, per_key, same, dm, dp))
            print(f"{what} at K = 4096 over 4 shards, 8 ticks: card == CPU bit for bit "
                  f"(every state leaf, sizes, overflow, the metric's NaNs); params and metric "
                  f"{'bit for bit too' if same else 'within rtol 1e-4'}"
                  f"{' on shard 0 (the others fit 0-2 items a key)' if per_key else ''} "
                  f"(max |diff| over all shards: metric {dm:.3g}, params {dp:.3g})")
    (lb, lc), (pb, pc) = streams["cuda"]
    del streams
    # S = 1 equals the local loop, on the card
    for per_key in (False, True):
        b1 = make_bank("rtbs", num_keys=4096, **hyp["rtbs"])
        s1b, s1c = shard_keyed_stream(lb, lc, 1, 4096)
        one = make_sharded_bank_loop(b1, model, make_data_mesh(1), retrain_every=RETRAIN_EVERY,
                                     train_keys=range(Q), per_key=per_key)(prng.key(3), s1b, s1c)
        loc = make_bank_run_loop(b1, model, retrain_every=RETRAIN_EVERY, train_keys=range(Q),
                                 per_key=per_key)(prng.key(3), lb, lc)
        check(_leaves_equal(torch, pytree.tree_map(lambda a: a[0], one), loc),
              f"[18] (b) S = 1 {'per key' if per_key else 'shared'} != make_bank_run_loop")
    print("[18] (b) S = 1: the key-sharded loop == make_bank_run_loop bit for bit (state, "
          "params, trace), shared and per key, on the card")
    # C.18: two shards fed shard 0's sub-stream end bit-identical
    b_s = pb["key"].shape[1] // 4
    twin = {f: torch.cat([v[:, :b_s], v[:, :b_s]], dim=1) for f, v in pb.items()}
    tc2 = torch.stack([pc[:, 0], pc[:, 0]], dim=-1)
    st2, p2, t2 = make_sharded_bank_loop(make_bank("rtbs", num_keys=1024, **hyp["rtbs"]), model,
                                         make_data_mesh(2), retrain_every=RETRAIN_EVERY,
                                         train_keys=range(Q), per_key=True)(prng.key(3), twin, tc2)
    check(_leaves_equal(torch, pytree.tree_map(lambda a: a[0], (st2, p2, t2)),
                        pytree.tree_map(lambda a: a[1], (st2, p2, t2))),
          "[18] (b) two shards fed the same sub-stream differ (ROADMAP C.18)")
    print(f"[18] (b) two shards fed the same sub-stream ({int(tc2[:, 0].sum())} arrivals) end "
          f"bit-identical: state, per-key params and trace (ROADMAP C.18)")

    # (c) compress_grads over mamba2_370m's parameter shapes, card == CPU
    shapes = [tuple(a.shape) for a in pytree.tree_leaves(
        zoo.build(get_config("mamba2_370m")).init_params(0))]
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(18)
    grads = [torch.randn(s, generator=g) for s in shapes]
    ef = [0.01 * torch.randn(s, generator=g) for s in shapes]
    (q_c, s_c), e_c = compress_grads(grads, ef)
    t0 = time.perf_counter()
    (q_g, s_g), e_g = compress_grads([x.cuda() for x in grads], [x.cuda() for x in ef])
    torch.cuda.synchronize()
    c_ms = (time.perf_counter() - t0) * 1e3
    check(_leaves_equal(torch, [x.cpu() for x in q_g + s_g + e_g], q_c + s_c + e_c),
          "[18] (c) compress_grads card != CPU")
    nparam = sum(x.numel() for x in grads)
    print(f"[18] (c) compress_grads over mamba2_370m's {len(shapes)} parameter shapes "
          f"({nparam} f32 values, random from a seed, with a random ef): card == CPU bit for bit "
          f"(int8 q, scales, f32 residuals); {c_ms:.1f} ms on the card with the copies in")
    del grads, ef, q_c, s_c, e_c, q_g, s_g, e_g
    torch.cuda.empty_cache()

    ex = _run_examples()
    wall = time.perf_counter() - t_phase
    print(f"[18] phase wall time {wall:.1f} s")
    return {"launches": launches["tbs_step_apply_banked"], "ticks_per_s": tps,
            "rows": rows, "bcap_s": bcap_s, "profile": profile, "examples": ex,
            "parity": diffs, "peak_gb": peak}


# ---------------------------------------------------------------------------
# phase 19: the dry run and the card against it
# ---------------------------------------------------------------------------
# (name, arch, shape, config overrides, the batch cut): each cut halves the
# batch until the deeper cost depth's meta peak_est fits in 0.75 of the card
# (what the doubled batch would need is printed beside it)
DRY_CHECKS = (("train", "mamba2_370m", "train_4k", {}, 16),
              ("prefill B4", "stablelm_12b", "prefill_32k", {"attention_impl": "pallas"}, 8),
              ("prefill B5", "mamba2_370m", "prefill_32k", {}, None),
              ("decode", "stablelm_12b", "decode_32k", {}, 32))
DRY_TIMED = 5           # timed steps after a warm-up, at the shallower depth
DRY_MEM_TOL = (0.05, 1 << 30)   # |card - meta| <= max(5 % of meta, 1 GiB)


def _spawn(args, out_path, children: list):
    """A CPU-only subprocess of this checkout writing to ``out_path``,
    appended to ``children``; (proc, file, path)."""
    import os
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    f = open(out_path, "w")
    proc = subprocess.Popen([sys.executable] + args, cwd=HERE, env=env, stdout=f,
                            stderr=subprocess.STDOUT, text=True)
    children.append((proc, f))
    return proc, f, out_path


def _host_check(name: str, tmp: Path, doubled: bool, children: list):
    """``dryrun.host_check`` of DRY_CHECKS' ``name`` in a subprocess."""
    _, arch, shape, over, batch = next(c for c in DRY_CHECKS if c[0] == name)
    spec = json.dumps(dict(arch=arch, shape_name=shape, overrides=over, global_batch=batch,
                           doubled=doubled))
    code = ("import json, sys; from repro_torch.launch import dryrun; "
            "print(json.dumps(dryrun.host_check(**json.loads(sys.argv[1]))))")
    return _spawn(["-c", code, spec], tmp / f"{name.replace(' ', '_')}.log", children)


def _wait(handle, what, timeout):
    proc, f, out_path = handle
    proc.wait(timeout=timeout)
    f.close()
    text = Path(out_path).read_text()
    check(proc.returncode == 0, f"[19] {what} exited {proc.returncode}:\n{text[-4000:]}")
    return text


def _ops_diff(a: dict, b: dict) -> dict:
    return {k: (a.get(k, 0), b.get(k, 0)) for k in sorted(set(a) | set(b))
            if a.get(k, 0) != b.get(k, 0)}


def _dry_card_step(torch, kernels, name, arch, shape, over, batch, L, timed: bool) -> dict:
    """One cut cell at ``L`` layers on the card: counted once (FlopCounterMode
    and the byte tracker, as on meta) with its peak device memory above what
    was allocated before its params, its launches; ``timed``: the median
    host-clock step over DRY_TIMED synchronized steps after a warm-up, and
    one more step under the profiler (device busy time, idle share, scopes
    and top kernels)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg, shp, step, args, mb = dryrun.build_cell(
        arch, shape, make_host_mesh(1, 1), overrides={**dryrun.BASE_OVERRIDES, **over,
                                                      "num_layers": L},
        device="cuda", global_batch=batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    c = dryrun.count_step(step, args)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    launches = {k: v for k, v in kernels.launches().items() if v}
    ms = None
    if timed:
        step(*args)
        torch.cuda.synchronize()
        ts = []
        for _ in range(DRY_TIMED):
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(ts)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        scopes = _SSM_SCOPES if arch.startswith("mamba2") else _LM_SCOPES
        prof_res = _breakdown(torch, prof, wall, "[19] (b)", scopes,
                              (("B4 kernel", "flash_attention"), ("B5 kernel", "ssd_scan")),
                              what=f"{name} step at {L} layers")
        del prof
    del args, step
    torch.cuda.empty_cache()
    return {"flops": c["flops"], "flops_by_op": c["flops_by_op"],
            "flops_masked": c["flops_masked"], "mem": mem, "tracker_peak": c["peak"],
            "launches": launches, "ms": ms, "profile": prof_res if timed else None,
            "count_s": c["seconds"], "mb": mb, "batch": shp.global_batch}


def _b4_b5_through_ops(torch, timer) -> dict:
    """(c) B4's and B5's outputs through the registered ops bit for bit
    against a direct launch of the same kernel on the same inputs, the
    launch counters, and the host time a call (the wrapper, the op alone,
    its CUDA implementation called as a function, the bare launch)."""
    from repro_torch.kernels._common import tma_strides
    from repro_torch.kernels.flash_attention import kernel as fk, ops as fa
    from repro_torch.kernels.ssd_scan import kernel as sk, ops as ss

    g = torch.Generator(device="cuda").manual_seed(19)
    out = {}
    for dt, shape, route in ((torch.bfloat16, (8, 2048, 32, 8, 160), "tensor_core"),
                             (torch.float32, (2, 512, 8, 2, 64), "cuda_core")):
        B, S, H, KV, hd = shape
        q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dt)
        k = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dt)
        v = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dt)
        n0, t0 = fa.flash_attention.launches, fa.flash_attention.tensor_core_launches
        got = fa.flash_attention(q, k, v)
        direct = torch.empty_like(q)
        if route == "tensor_core":
            fk.flash_attention_tc(q, k, v, direct, True, 0,
                                  tuple(tma_strides(x.shape, x.stride()) for x in (q, k, v)))
        else:
            fk.flash_attention(q, k, v, direct, True, 0)
        torch.cuda.synchronize()
        check(torch.equal(got, direct), f"[19] (c) B4 {route}: the op != a direct launch")
        check(fa.flash_attention.launches == n0 + 1 and fa.flash_attention.tensor_core_launches
              == t0 + (route == "tensor_core"), f"[19] (c) B4 {route}: counters off")
        print(f"[19] (c) B4 {route} {list(shape)} {str(dt)[6:]}: through "
              f"torch.ops.repro_torch.flash_attention == a direct launch, bit for bit; "
              f"launches +1 (tensor-core +{int(route == 'tensor_core')})")
        out[f"b4_{route}_equal"] = True
    for dt, route in ((torch.bfloat16, "tensor_core"), (torch.float32, "cuda_core")):
        B, S, H, G, N, P, Q = (4, 4096, 32, 1, 128, 64, 256) if dt == torch.bfloat16 \
            else (2, 512, 8, 1, 64, 32, 64)
        x, dtt, a, Bm, Cm = _b5_operands(torch, B, S, H, G, N, P, dt, g, strided=True,
                                         model=True)
        n0, t0 = ss.ssd_scan.launches, ss.ssd_scan.tensor_core_launches
        y, st = ss.ssd_scan(x, dtt, a, Bm, Cm, chunk=Q)
        yd, sd = torch.empty_like(y), torch.empty_like(st)
        if route == "tensor_core":
            sk.ssd_scan_tc(x, dtt, a, Bm, Cm, None, yd, sd, Q,
                           tuple(tma_strides(t.shape, t.stride()) for t in (x, Bm, Cm)))
        else:
            sk.ssd_scan(x, dtt, a, Bm, Cm, None, yd, sd, Q)
        torch.cuda.synchronize()
        check(torch.equal(y, yd) and torch.equal(st, sd),
              f"[19] (c) B5 {route}: the op != a direct launch")
        check(ss.ssd_scan.launches == n0 + 1 and ss.ssd_scan.tensor_core_launches
              == t0 + (route == "tensor_core"), f"[19] (c) B5 {route}: counters off")
        print(f"[19] (c) B5 {route} [B, S, H, G, N, P, Q] = {[B, S, H, G, N, P, Q]} "
              f"{str(dt)[6:]} (the conv output's views): through torch.ops.repro_torch.ssd_scan "
              f"== a direct launch, y and state bit for bit; launches +1")
        out[f"b5_{route}_equal"] = True
    # host time a call at a small shape (the device idle behind a queued sleep)
    bf = torch.bfloat16
    q = torch.randn((1, 128, 2, 64), generator=g, device="cuda").to(bf)
    o = torch.empty_like(q)
    st = tuple(tma_strides(q.shape, q.stride()) for _ in range(3))
    b4 = {"wrapper": timer.host(lambda: fa.flash_attention(q, q, q), 200),
          "op": timer.host(lambda: fa.attend(q, q, q, True, 0, "tensor_core"), 200),
          "impl": timer.host(lambda: fa._attend_cuda(q, q, q, True, 0, "tensor_core"), 200),
          "launch": timer.host(lambda: fk.flash_attention_tc(q, q, q, o, True, 0, st), 200)}
    x, dtt, a, Bm, Cm = _b5_operands(torch, 1, 256, 2, 1, 16, 16, bf, g, strided=False,
                                     model=True)
    y, s_ = torch.empty_like(x), torch.empty((1, 2, 16, 16), device="cuda")
    sts = tuple(tma_strides(t.shape, t.stride()) for t in (x, Bm, Cm))
    b5 = {"wrapper": timer.host(lambda: ss.ssd_scan(x, dtt, a, Bm, Cm, chunk=64), 200),
          "op": timer.host(lambda: ss.scan(x, dtt, a, Bm, Cm, None, 64, "tensor_core"), 200),
          "impl": timer.host(lambda: ss._scan_cuda(x, dtt, a, Bm, Cm, None, 64,
                                                   "tensor_core"), 200),
          "launch": timer.host(lambda: sk.ssd_scan_tc(x, dtt, a, Bm, Cm, None, y, s_, 64, sts),
                               200)}
    for name, h in (("B4", b4), ("B5", b5)):
        print(f"[19] (c) {name} host ms a call (median of 200): wrapper {h['wrapper']:.4f}, "
              f"the op {h['op']:.4f}, its CUDA implementation as a function "
              f"{h['impl']:.4f}, the bare ctypes launch {h['launch']:.4f}: the op's dispatch "
              f"{h['op'] - h['impl']:.4f} ms, the wrapper over a direct launch "
              f"{h['wrapper'] - h['launch']:.4f} ms")
    out["b4_host_ms"], out["b5_host_ms"] = b4, b5
    return out


def _dry_compare(name, arch, shape, over, batch, meta, card, total) -> dict:
    """(b) one cut cell: the card's counts, memory and time against the meta
    side (``dryrun.host_check``); raises on a FLOP gap, on memory past
    DRY_MEM_TOL, on an inexact extrapolation, or on a cut deeper than the
    card's memory forces."""
    from repro_torch.config import SHAPES
    from repro_torch.launch import dryrun

    u1, u2, u_full = card["u"]
    cut = f"batch {meta['l1']['global_batch']} of {SHAPES[shape].global_batch}" if batch \
        else "the full batch"
    print(f"[19] (b) {name}: {arch}/{shape} {over or ''} at {u1} and {u2} of {u_full} "
          f"layers, {cut}")
    if "l2_doubled" in meta:
        d = meta["l2_doubled"]
        print(f"[19] (b)   cut: meta peak_est at {u2} layers "
              f"{meta['l2']['peak_est_bytes'] / 1e9:.2f} GB; with batch {d['global_batch']} "
              f"{d['peak_est_bytes'] / 1e9:.2f} GB, past 0.75 of the card's "
              f"{total / 1e9:.2f} GB")
        check(d["peak_est_bytes"] > 0.75 * total,
              f"[19] (b) {name}: the batch cut is deeper than the card's memory forces")
    res = {"arch": arch, "shape": shape, "overrides": over,
           "batch": meta["l1"]["global_batch"], "depths": [u1, u2, u_full]}
    for lv in ("l1", "l2"):
        c, m = card[lv], meta[lv]
        diff = _ops_diff(c["flops_by_op"], m["flops_by_op"])
        tol = max(DRY_MEM_TOL[0] * m["peak_est_bytes"], DRY_MEM_TOL[1])
        print(f"[19] (b)   {m['num_layers']} layers: FLOPs card {c['flops']:.6e} meta "
              f"{m['flops']:.6e} ({'equal' if c['flops'] == m['flops'] else 'DIFFER'}; by op "
              f"{c['flops_by_op']}); memory card {c['mem'] / 1e9:.3f} GB "
              f"(max_memory_allocated above the baseline) vs meta peak_est "
              f"{m['peak_est_bytes'] / 1e9:.3f} GB "
              f"({(c['mem'] / m['peak_est_bytes'] - 1) * 100:+.2f} %, tolerance "
              f"{tol / 1e9:.3f} GB); the tracker on the card {c['tracker_peak'] / 1e9:.3f} GB "
              f"vs on meta {m['peak'] / 1e9:.3f} GB; launches {c['launches']}; counted in "
              f"{c['count_s']:.1f} s (meta {m['count_s']:.1f} s)")
        check(not diff and c["flops"] == m["flops"],
              f"[19] (b) {name} at {m['num_layers']} layers: card FLOPs != meta, by op "
              f"(card, meta) {diff}")
        check(abs(c["mem"] - m["peak_est_bytes"]) <= tol,
              f"[19] (b) {name} at {m['num_layers']} layers: card memory {c['mem']} vs "
              f"meta peak_est {m['peak_est_bytes']}, past {tol:.0f}")
        res[lv] = {"flops": c["flops"], "meta_flops": m["flops"], "mem": c["mem"],
                   "peak_est": m["peak_est_bytes"], "tracker_card": c["tracker_peak"],
                   "tracker_meta": m["peak"], "launches": c["launches"]}
    ext = dryrun._extrapolate({"flops": card["l1"]["flops"], "bytes": 0.0, "coll": {}},
                              {"flops": card["l2"]["flops"], "bytes": 0.0, "coll": {}},
                              u1, u2, u_full)["flops"]
    full_meta = meta["full"]["flops"]
    print(f"[19] (b)   extrapolated from the card's two depths to {u_full} layers: "
          f"{ext:.6e}; meta at full depth {full_meta:.6e} (difference {ext - full_meta:.6g})")
    check(abs(ext - full_meta) <= 1e-12 * full_meta,
          f"[19] (b) {name}: extrapolation {ext} != meta full depth {full_meta}")
    c1, m1 = card["l1"], meta["l1"]
    check(c1["flops_masked"] == m1["flops_masked"],
          f"[19] (b) {name}: the masked count on the card != meta")
    bound = max(m1["t_compute"], m1["t_memory"]) * 1e3
    by = "t_compute" if m1["t_compute"] >= m1["t_memory"] else "t_memory"
    bound_m = max(m1["t_compute_masked"], m1["t_memory"]) * 1e3
    print(f"[19] (b)   time at {m1['num_layers']} layers: median step {c1['ms']:.3f} ms over "
          f"{DRY_TIMED} after a warm-up; max(t_compute, t_memory) {bound:.3f} ms ({by}; "
          f"t_compute {m1['t_compute'] * 1e3:.3f}, t_memory {m1['t_memory'] * 1e3:.3f}): "
          f"the bound is {bound / c1['ms'] * 100:.1f} % of the step; with B4's calls at the "
          f"pairs their masks keep, t_compute {m1['t_compute_masked'] * 1e3:.3f} ms and the "
          f"bound {bound_m:.3f} ms, {bound_m / c1['ms'] * 100:.1f} % of the step")
    res.update(extrapolated=ext, meta_full=full_meta, ms=c1["ms"], bound_ms=bound,
               bound_by=by, bound_masked_ms=bound_m, profile=c1["profile"])
    return res


def phase_dryrun(torch, np, kernels, timer, quiet=None, busy=None) -> dict:
    """Phase 19, in two parts. While the host runs nothing else of this
    script: (c) B4 and B5 through their registered ops (bit for bit, the
    counters, host ms a call), (b) each cut cell at its shallower depth on
    the card: counted, timed and profiled, and then ``quiet()`` (phase 20's
    measured runs). Then (a) the dry run of all 40 cells on the 16 x 16 mesh
    and (b)'s meta counts run in CPU subprocesses while the card counts each
    cell at its deeper depth (untimed) and runs ``busy()`` (phase 20's
    checks); (b) is compared and the grid waited for after them."""
    import os
    import shutil
    import tempfile

    from repro_torch.config import get_config
    from repro_torch.kernels._bench import card
    from repro_torch.launch import dryrun, hw

    t_phase = time.perf_counter()
    smi = card()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[19] card: {smi}; total_memory {total} B ({total / 1e9:.2f} GB) against hw's "
          f"{hw.HBM_PER_CHIP / 1e9:.0f} GB (H100 SXM spec sheet); the dry run's constants: "
          f"{hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16, {hw.HBM_BW / 1e12:.2f} TB/s (spec "
          f"sheet); host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} usable")

    # the host's timings first, with no subprocess of this script running
    ops_res = _b4_b5_through_ops(torch, timer)
    cards = {}
    for name, arch, shape, over, batch in DRY_CHECKS:
        o1, o2, u_full, u1, u2 = dryrun.cost_depths(get_config(arch))
        cards[name] = {"u": (u1, u2, u_full), "o2": o2,
                       "l1": _dry_card_step(torch, kernels, name, arch, shape, over, batch,
                                            o1["num_layers"], True)}
    t_quiet = time.perf_counter() - t_phase
    t_hooks = 0.0
    if quiet is not None:
        t0 = time.perf_counter()
        quiet()
        t_hooks += time.perf_counter() - t0

    out_dir = HERE / "results" / "dryrun_torch"
    shutil.rmtree(out_dir, ignore_errors=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    children = []
    try:
        grid = _spawn(["-m", "repro_torch.launch.dryrun", "--all", "--mesh", "single",
                       "--jobs", "6", "--out", str(out_dir)], tmp / "grid.log", children)
        metas = {name: _host_check(name, tmp, batch is not None, children)
                 for name, _, _, _, batch in DRY_CHECKS}
        t0 = time.perf_counter()
        for name, arch, shape, over, batch in DRY_CHECKS:
            cards[name]["l2"] = _dry_card_step(torch, kernels, name, arch, shape, over, batch,
                                               cards[name]["o2"]["num_layers"], False)
        t_card = time.perf_counter() - t0
        if busy is not None:
            t0 = time.perf_counter()
            busy()
            t_hooks += time.perf_counter() - t0
        results = {}
        for name, arch, shape, over, batch in DRY_CHECKS:
            meta = json.loads(_wait(metas[name], f"host_check {name}", 600)
                              .strip().splitlines()[-1])
            results[name] = _dry_compare(name, arch, shape, over, batch, meta, cards[name],
                                         total)
        text = _wait(grid, "the dry run", 900)
    finally:                    # a failed check leaves no subprocess behind
        for proc, f in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
    lines = [ln for ln in text.splitlines() if ln.startswith("[dryrun]")]
    counted = [ln for ln in lines if "fits=" in ln]
    skipped = [ln for ln in lines if "SKIPPED" in ln]
    for ln in lines:
        print(f"[19] (a) {ln}")
    recs = sorted(out_dir.glob("*.json"))
    check(len(counted) == 33 and len(skipped) == 7 and len(recs) == 40,
          f"[19] (a) {len(counted)} counted lines, {len(skipped)} skipped, {len(recs)} records")
    shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase - t_hooks
    print(f"[19] (a) 33 cells counted and 7 skipped, {len(recs)} records in "
          f"{out_dir.relative_to(HERE)}; phase wall time {wall:.1f} s without phase 20's "
          f"{t_hooks:.1f} s inside it (the quiet part {t_quiet:.1f} s, the card's deeper "
          f"counts {t_card:.1f} s)")
    return {"checks": results, "ops": ops_res, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 20: the LM driver on the zoo's other trainable families
# ---------------------------------------------------------------------------
# (arch, the depth of its resume check: a cut at full width whose
# checkpoints stay small; zamba2's layers come in groups of attn_every = 6)
ZOO_TRAIN = (("granite_moe_3b", 2), ("zamba2_2p7b", 6))
ZOO_TRAIN_TICKS = 8            # two retrains
# the full-size runs whose first retrain (at tick 3) a second run replays
# from the seed: the MoE arch, whose dispatch backward this checks; the
# hybrid's retrain runs twice from one state in its resume check (b)
ZOO_REPLAY = {"granite_moe_3b"}
# card vs CPU, one retrain of the smoke config in f32: tests/test_torch_train.py's
# tolerances for the port against JAX (losses 2e-5 relative, params 1e-4)
ZOO_FIT_LOSS_RTOL, ZOO_FIT_PARAM_TOL = 2e-5, 1e-4


def _digest(torch, tree, device="cuda") -> list[int]:
    """One int64 a leaf: the sum, wrapping mod 2^64, of the leaf's words
    (its elements' bits read as integers) times fixed pseudo-random weights
    in [1, 2^31). An integer sum does not depend on its order, so two runs'
    digests are equal exactly when no word differs, up to the chance that
    several differences cancel; one differing word always shows."""
    from torch.utils import _pytree as pytree

    chunk = 1 << 24
    g = torch.Generator(device=device).manual_seed(20)
    w = torch.randint(1, 1 << 31, (chunk,), generator=g, device=device, dtype=torch.int64)
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for x in pytree.tree_leaves(tree):
        words = x.detach().reshape(-1).view(as_int[x.element_size()])
        s = torch.zeros((), dtype=torch.int64, device=device)
        for lo in range(0, words.numel(), chunk):
            c = words[lo:lo + chunk]
            s += (c.long() * w[:c.numel()]).sum()
        out.append(int(s))
    return out


def _fit_parity(torch, np, arch: str) -> str:
    """One retrain (2 AdamW steps on 3-row minibatches of 16 tokens) of
    ``arch``'s smoke config in f32 from the same params and rows on the card
    and on the CPU: step losses, grad norms and the eval after it within
    ZOO_FIT_LOSS_RTOL, every param within ZOO_FIT_PARAM_TOL."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch import convert
    from repro_torch.config import get_smoke_config
    from repro_torch.core.api import SampleView
    from repro_torch.manage import make_sgd_adapter
    from repro_torch.models import zoo
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import sorted_tree
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    api = zoo.build(cfg)
    tree = convert.lm_params_to_numpy(api.init_params(5))
    rng = np.random.default_rng(20)
    items = rng.integers(0, cfg.vocab_size, (12, 16), dtype=np.int32)
    picks = rng.integers(0, 12, (2, 3))
    held = rng.integers(0, cfg.vocab_size, (4, 16), dtype=np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        p = convert.lm_params_from_numpy(cfg, tree, device=dev)
        step = make_train_step(api, AdamWConfig(lr=1e-3), warmup=1, total_steps=40)
        ms = []

        def recording(params, opt, batch, _step=step, _ms=ms):
            params, opt, m = _step(params, opt, batch)
            _ms.append((float(m["loss"]), float(m["grad_norm"])))
            return params, opt, m

        ad = make_sgd_adapter(init_params=lambda: p, train_step=recording,
                              init_opt_state=adamw_init, loss=api.loss, batch_field="tokens",
                              train_batch=3, retrain_steps=2, device=dev)
        view = SampleView(items=torch.from_numpy(items).to(dev),
                          mask=torch.ones(12, dtype=torch.bool, device=dev),
                          size=torch.tensor(12, device=dev))
        st = ad.fit(None, ad.init(), view, rows=torch.from_numpy(picks).to(dev))
        ev = float(ad.evaluate(st, torch.from_numpy(held).to(dev), 4))
        out[dev] = (ms, ev, [x.cpu() for x in pytree.tree_leaves(sorted_tree(st["params"]))])
    (mg, eg, pg), (mc, ec, pc) = out["cuda"], out["cpu"]
    for a, b in zip([x for m in mg for x in m] + [eg], [x for m in mc for x in m] + [ec]):
        check(abs(a - b) <= ZOO_FIT_LOSS_RTOL * abs(b),
              f"[20] (d) {arch}: card {mg}, eval {eg} vs CPU {mc}, eval {ec}")
    worst = max(float(((a - b).abs() / (ZOO_FIT_PARAM_TOL * (1 + b.abs()))).max())
                for a, b in zip(pg, pc))
    check(worst <= 1.0, f"[20] (d) {arch}: params beyond {ZOO_FIT_PARAM_TOL} (x {worst:.3g})")
    return (f"step losses {[round(x[0], 6) for x in mg]} (CPU {[round(x[0], 6) for x in mc]}), "
            f"eval after {eg:.6f} vs {ec:.6f}, params within {worst:.3g} of the tolerance")


MOE_PASSES = 8


def _moe_grads(torch, cfg, gather: bool) -> dict:
    """One MoE layer of ``cfg`` at the fit's 16 x 512 tokens in bf16, run
    forward and backward MOE_PASSES times from the same inputs: how many
    distinct gradient sets (x and the layer's params) the passes give, and
    the median ms of a pass, with the dispatch's ordered backward or,
    ``gather``, with a plain ``torch.gather`` in its place (a scatter-add
    with atomics over repeated token indices)."""
    from repro_torch.models import moe as M

    g = torch.Generator(device="cuda").manual_seed(21)
    p = {k: v.to(torch.bfloat16) for k, v in M.moe_params(cfg, g).items()}
    x = (torch.randn((16, 512, cfg.d_model), generator=g, device="cuda") * 0.5).bfloat16()
    w = torch.randn((16, 512, cfg.d_model), generator=g, device="cuda").bfloat16()
    orig = M._DispatchRows.apply
    if gather:
        M._DispatchRows.apply = lambda xf, tok, pos: torch.gather(
            xf, 1, tok[..., None].expand(*tok.shape, xf.shape[-1]))
    try:
        distinct, ms = [], []
        for _ in range(MOE_PASSES):
            live = [x.clone().requires_grad_(True)] + [
                v.clone().requires_grad_(True) for v in p.values()]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = M.apply_moe(cfg, dict(zip(p, live[1:])), live[0])
            grads = torch.autograd.grad((y * w).float().sum(), live)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if not any(_leaves_equal(torch, grads, d) for d in distinct):
                distinct.append(grads)
    finally:
        M._DispatchRows.apply = orig
    return {"distinct": len(distinct), "ms": statistics.median(ms), "passes": MOE_PASSES}


def _profile_fit_step(torch, np, run, args, tag: str) -> dict:
    """One more AdamW step of ``run``'s model on ``args.train_batch`` rows of
    its stream, profiled by scope (a retrain's fit is ``retrain_steps`` such
    steps); updates ``run``'s model state in place."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.steps import make_train_step

    step = make_train_step(run.api, AdamWConfig(lr=args.lr))
    batch = {"tokens": torch.from_numpy(run.stream.batch(args.ticks, args.train_batch, 0))
             .to(run.dev)}
    params, opt = run.model_state["params"], run.model_state["opt"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    res = _breakdown(torch, prof, wall, tag=tag, scopes=TRAIN_SCOPES,
                     named=(("B5 kernel", "ssd_scan_tc_kernel"),),
                     what=f"fit step ({args.train_batch} x {args.seq_len})")
    res["backward_ms"], k = _between_ms(torch, np, prof, "train.forward", "train.optim")
    print(f"{tag}   train.backward         {res['backward_ms']:9.3f} ms  "
          f"{100 * res['backward_ms'] / res['device_ms']:5.1f} % of device time ({k} kernels "
          f"between train.forward and train.optim, launched by autograd's thread: the "
          f"recompute's in the lm.* rows too)")
    return res


def _zoo_train_run(torch, np, kernels, train, arch: str) -> dict:
    """Phase 20's measured run of one arch (:class:`ZooTrain`): the driver
    over ZOO_TRAIN_TICKS ticks at full size, its checks, its rates, one more
    fit step profiled, and (ZOO_REPLAY) digests of the state before and
    after the first retrain."""
    from torch.utils import _pytree as pytree

    from repro_torch.kernels.ssd_scan import ops as ss_ops

    flags = ["--arch", arch] + TRAIN_FLAGS[2:]
    args = train.parse_args(flags + ["--ticks", str(ZOO_TRAIN_TICKS)])
    T, R, steps = ZOO_TRAIN_TICKS, args.retrain_every, args.retrain_steps
    t_arch = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run = train.LocalRun(args)
    cfg, L = run.cfg, run.cfg.num_layers
    params = run.model_state["params"]
    nparam = sum(x.numel() for x in pytree.tree_leaves(params))
    state_b = sum(x.numel() * x.element_size() for x in pytree.tree_leaves(
        (params, run.model_state["opt"]["m"], run.model_state["opt"]["v"])))
    del params
    print(f"[20] {arch}: {' '.join(flags[2:])}, {T} ticks: {L} layers, d_model {cfg.d_model}, "
          f"{cfg.family}, {cfg.dtype} compute under remat={cfg.remat}; {nparam / 1e9:.3f} B "
          f"params, {state_b / 1e9:.2f} GB of {cfg.param_dtype} params and AdamW moments")
    rows, walls, deltas, digests, fit_s = [], [], [], {}, []
    for t in range(T):
        kernels.reset_launches()
        t0 = time.perf_counter()
        rows.append(run.tick(t))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        deltas.append(dict(kernels.launches(), ssd_tc=ss_ops.ssd_scan.tensor_core_launches,
                           ssd_rec=ss_ops.ssd_scan.recompute_launches))
        if (t + 1) % R == 0:
            fit_s.append(run.last_fit_s)
        if t in (R - 2, R - 1) and arch in ZOO_REPLAY:   # around the first retrain
            digests[t] = _digest(torch, run.model_state)
    peak = torch.cuda.max_memory_allocated() - base
    prof_res = _profile_fit_step(torch, np, run, args, f"[20] {arch}")
    del run
    torch.cuda.empty_cache()
    evals = [r["eval_loss"] for r in rows]
    fast = [w for t, w in enumerate(walls) if (t + 1) % R]
    ntok = steps * args.train_batch * args.seq_len
    check(all(math.isfinite(e) for e in evals), f"[20] {arch}: eval losses {evals}")
    _check_w(np, [r["total_weight"] for r in rows], [args.batch_per_tick] * T, TRAIN_LAM)
    check(all(r["sample_size"] <= args.reservoir for r in rows), "[20] |S| above --reservoir")
    # B5: a Mamba2 layer's forward once an eval; a fit step runs it again in
    # each checkpoint's recompute (the hybrid's nested checkpoints: twice)
    r_ = 3 if cfg.family == "hybrid" else 2
    n5 = L if cfg.ssm_state else 0
    for t, d in enumerate(deltas):
        fit = (t + 1) % R == 0
        want, rec = (n5 * (2 + r_ * steps), n5 * (r_ - 1) * steps) if fit else (n5, 0)
        check(d["tbs_step_apply"] == 1, f"[20] {arch} tick {t}: B1 {d['tbs_step_apply']}")
        check(d["ssd_scan"] == d["ssd_tc"] == want and d["ssd_rec"] == rec,
              f"[20] {arch} tick {t}: B5 launched {d['ssd_scan']} times ({d['ssd_tc']} "
              f"tensor-core, {d['ssd_rec']} recomputes), want {want} ({rec} recomputes)")
        check(d["flash_attention"] == 0, f"[20] {arch} tick {t}: B4 launched")
    print(f"[20] {arch} eval loss by tick: {[round(e, 4) for e in evals]}; W exact; |S| "
          f"{[r['sample_size'] for r in rows]}")
    print(f"[20] {arch}: {T} ticks in {sum(walls):.3f} s = {T / sum(walls):.3f} ticks/s "
          f"(fast ticks {1e3 * statistics.median(fast):.1f} ms median); seconds a retrain "
          f"({steps} AdamW steps on {args.train_batch} x {args.seq_len}) "
          f"{[round(x, 4) for x in fit_s]}; fit {ntok / fit_s[-1]:.0f} tokens/s (the second "
          f"retrain); peak {peak / 1e9:.2f} GB (max_memory_allocated above the "
          f"{base / 1e9:.2f} GB held before it); {time.perf_counter() - t_arch:.1f} s")
    if n5:
        print(f"[20] {arch} B5 launches a tick: {n5} a fast tick (the eval), "
              f"{n5 * (2 + r_ * steps)} a retrain tick ({2 * n5} evals, {steps} fit steps of "
              f"{n5} forwards + {(r_ - 1) * n5} recomputes: each group and each layer "
              f"checkpointed), all tensor-core; {sum(d['ssd_scan'] for d in deltas)} in {T} "
              f"ticks, {sum(d['ssd_rec'] for d in deltas)} of them recomputes")
    return {"arch": arch, "cfg": cfg, "args": args, "params": nparam, "state_bytes": state_b,
            "peak": peak, "evals": evals, "fit_s": fit_s,
            "ticks_per_s": T / sum(walls), "fit_tokens_per_s": ntok / fit_s[-1],
            "prof": prof_res, "digests": digests, "b5": sum(d["ssd_scan"] for d in deltas),
            "b5_recompute": sum(d["ssd_rec"] for d in deltas),
            "b1": sum(d["tbs_step_apply"] for d in deltas)}


def _zoo_train_checks(torch, np, train, res: dict, cut: int, meta_handle) -> None:
    """Phase 20's checks of one arch after its measured run: (a) the replay,
    (b) the resume at a depth cut, (c) the dry run's count, (d) card vs
    CPU, (e) for MoE the dispatch's backward on its own."""
    arch, cfg, args = res["arch"], res["cfg"], res["args"]
    R, digests = args.retrain_every, res["digests"]
    flags = ["--arch", arch] + TRAIN_FLAGS[2:]
    t_arch = time.perf_counter()

    # (a) the first retrain replayed by a second run from the seed: the state
    # before it and after it bit for bit the first run's
    if digests:
        t0 = time.perf_counter()
        run = train.LocalRun(args)
        for t in range(R):
            run.tick(t)
            if t in digests:
                check(_digest(torch, run.model_state) == digests[t],
                      f"[20] (a) {arch}: the replay's state after tick {t} differs from the "
                      f"first run's")
        del run
        torch.cuda.empty_cache()
        print(f"[20] (a) {arch}: ticks 0-{R - 1} replayed from the seed in a second run: "
              f"params and AdamW moments before and after the retrain at tick {R - 1} bit "
              f"for bit the first run's ({len(digests[R - 1])} leaves, weighted digests); "
              f"{time.perf_counter() - t0:.1f} s")

    # (b) checkpoint and resume at a depth cut of full width (2 AdamW steps a
    # retrain): its retrain at tick 7 runs twice from one state, in the
    # unbroken run and in the resumed one
    rc = _resume_check(torch, np, train, flags + ["--layers", str(cut), "--retrain-steps", "2"],
                       ZOO_TRAIN_TICKS, R, f"[20] (b) {arch}")
    print(f"[20] (b) {arch} at {cut} layers of full width, 2 AdamW steps a retrain: stopped "
          f"at tick {R}, resumed to {ZOO_TRAIN_TICKS}: every tick's losses, W and |S| and the "
          f"final state's {rc['leaves']} leaves ({rc['bytes'] / 1e9:.3f} GB) bit for bit the "
          f"unbroken run's (the checkpoint {rc['ck_gb']:.2f} GB); "
          f"{sum(v for k, v in rc.items() if k.endswith('_s')):.1f} s")

    # (c) the dry run's count of the same fit step, a CPU subprocess
    meta = json.loads(_wait(meta_handle, f"host_check {arch}", 300).strip().splitlines()[-1])
    est, peak = meta["full"]["peak_est_bytes"], res["peak"]
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[20] (c) {arch}: peak {peak / 1e9:.2f} GB (max_memory_allocated over the run) vs "
          f"the dry run's peak_est {est / 1e9:.2f} GB for one fit step on a 1 x 1 mesh at "
          f"batch {args.train_batch} x {args.seq_len} ({100 * (peak / est - 1):+.2f} %; "
          f"resident {meta['full']['resident'] / 1e9:.2f} GB + step peak "
          f"{meta['full']['peak'] / 1e9:.2f} GB), {100 * est / total:.1f} % of the card's "
          f"{total / 1e9:.2f} GB: no cut (fits 0.75)")
    check(est <= 0.75 * total, f"[20] (c) {arch}: the dry run's {est} B pass 0.75 of the card")
    res["peak_est"] = est

    # (d) card vs CPU, one retrain of the smoke config in f32
    t0 = time.perf_counter()
    line = _fit_parity(torch, np, arch)
    print(f"[20] (d) {arch} smoke config, f32, one retrain of 2 AdamW steps on 3 x 16 rows, "
          f"card vs CPU: {line}; {time.perf_counter() - t0:.1f} s")
    if cfg.num_experts:
        # (e) the MoE dispatch's backward on its own (ROADMAP C.20)
        det, plain = _moe_grads(torch, cfg, False), _moe_grads(torch, cfg, True)
        check(det["distinct"] == 1,
              f"[20] (e) {arch}: the dispatch's backward gave {det['distinct']} results")
        print(f"[20] (e) {arch} one MoE layer at 16 x 512 tokens, bf16, {MOE_PASSES} backward "
              f"passes from the same inputs: {det['distinct']} distinct gradient set(s) with "
              f"the dispatch's ordered backward ({det['ms']:.3f} ms a forward and backward); "
              f"{plain['distinct']} with a plain torch.gather's (atomic scatter-add, "
              f"{plain['ms']:.3f} ms)")
        res["moe_dispatch"] = {"ordered": det, "gather": plain}
    print(f"[20] {arch} checks {time.perf_counter() - t_arch:.1f} s")


class ZooTrain:
    """Phase 20: ``python -m repro_torch.launch.train`` on granite_moe_3b
    (MoE, 3.3 B params) and zamba2_2p7b (hybrid, 54 Mamba2 layers and a
    shared block) at full width and depth under ``cfg.remat``, with the
    train cell's flags over ZOO_TRAIN_TICKS ticks (two retrains), in two
    parts. :meth:`runs`, while no subprocess of this script runs: per arch
    the parameter count and state bytes; ticks/s, seconds a retrain, fit
    tokens/s; eval loss by tick, W exact, |S| bounded, B1 once a tick,
    zamba2's B5 launches by kind, all tensor-core; one more fit step
    profiled by scope. :meth:`checks`, which may overlap phase 19's CPU
    subprocesses: (a) the first retrain of the archs in ZOO_REPLAY replayed
    from the seed in a second run, bit for bit; (b) checkpoint and resume
    at a depth cut of full width, bit for bit; (c) the peak beside the dry
    run's count of one fit step at the
    same shape (CPU subprocesses on meta tensors); (d) one retrain of the
    smoke config in f32, card vs CPU; (e) the MoE dispatch's backward on
    its own, several passes."""

    def __init__(self, torch, np, kernels):
        from repro_torch.launch import train

        self.torch, self.np, self.kernels, self.train = torch, np, kernels, train
        self.res, self.t_runs, self.t_checks = [], 0.0, 0.0

    def runs(self) -> None:
        t0 = time.perf_counter()
        for arch, _ in ZOO_TRAIN:
            self.res.append(_zoo_train_run(self.torch, self.np, self.kernels, self.train, arch))
        self.t_runs = time.perf_counter() - t0

    def checks(self) -> None:
        import shutil
        import tempfile

        t0 = time.perf_counter()
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_zt_"))
        args = self.train.parse_args(TRAIN_FLAGS)
        code = ("import json, sys; from repro_torch.launch import dryrun; print(json.dumps("
                "dryrun.host_check(sys.argv[1], 'train_4k', global_batch=int(sys.argv[2]), "
                "seq_len=int(sys.argv[3]), overrides={'microbatches': 1})))")
        children = []
        try:
            metas = {arch: _spawn(["-c", code, arch, str(args.train_batch), str(args.seq_len)],
                                  tmp / f"{arch}.log", children) for arch, _ in ZOO_TRAIN}
            for (arch, cut), res in zip(ZOO_TRAIN, self.res):
                _zoo_train_checks(self.torch, self.np, self.train, res, cut, metas[arch])
        finally:
            for proc, f in children:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                f.close()
            shutil.rmtree(tmp, ignore_errors=True)
        self.t_checks = time.perf_counter() - t0
        print(f"[20] phase wall time {self.t_runs + self.t_checks:.1f} s: the runs "
              f"{self.t_runs:.1f} s, the checks {self.t_checks:.1f} s")


# ---------------------------------------------------------------------------
# the Sec. 5 schemes over a process group (ROADMAP A.7): one reservoir shard
# a rank of a gloo group, every rank on the one card (NCCL refuses two ranks
# on one GPU), held to the stacked form at S = 4: phase 16's cell (n = 2^20,
# 65,536 arrivals a tick, 48 ticks) re-sharded to 4 shards of 2^19 slots,
# D-T-TBS at n_s = n / 4 (cap 4 n_s), phase 18's bank at K = 2^20 over 4
# shards (16 ticks), and the LM driver under torch.distributed.run
RK_S, RK_TIMEOUT = 4, 300
# phase 16's driver flags at --shards 4, cut to 2 layers (the script's time limit)
RK_TRAIN_FLAGS = [{"--shards": str(RK_S), "--layers": "2"}.get(SHARD_TRAIN_FLAGS[i - 1], f)
                  for i, f in enumerate(SHARD_TRAIN_FLAGS)]


def _rk_cell(small: bool = False) -> dict:
    """Phase 21's sizes; ``small`` for a rehearsal on the CPU."""
    if small:
        return dict(S=RK_S, n=4095, cap_s=2048, T=12, b=256, ns=1024, cap_d=4096, c_T=8,
                    c_cap_s=4096 + 256, K=4096, bank_n=8, bank_b=512, bank_bcap=8,
                    bank_T=6, Q=4)
    return dict(S=RK_S, n=SH_N, cap_s=1 << 19, T=SH_T, b=BCAP_MAIN, ns=SH_N // RK_S,
                cap_d=4 * (SH_N // RK_S), c_T=8, c_cap_s=SH_N + BCAP_MAIN, K=K_BANK,
                bank_n=N_BANK, bank_b=B_BANK, bank_bcap=BCAP_BANK, bank_T=16, Q=Q_BANK)


def _rk_sampler(scheme: str, c: dict, dev, shards: int):
    from repro_torch.core.api import make_sampler

    if scheme == "drtbs":
        cap_s = c["cap_s"] if shards > 1 else c["c_cap_s"]
        return make_sampler("drtbs", n=c["n"], lam=LAM, cap_s=cap_s, device=dev)
    return make_sampler("dttbs", n=c["ns"], lam=LAM, batch_size=float(c["b"] // shards),
                        cap=c["cap_d"], device=dev)


def _rk_sync(torch, dev, group: bool = True) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if group:
        torch.distributed.barrier()


def _rk_run(torch, kernels, scheme, c, mesh, dev, rank, by_hand=False):
    """One sharded run of ``scheme`` after a warm-up on its first retrain's
    ticks: ``(state, params, trace, wall s, launches, run, stream, (W_t,
    C_t))``. ``by_hand`` drives the loop's tick a tick at a time (the trace
    the loop's, bit for bit) and records W_t and C_t, else None."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import prng
    from repro_torch.manage import (init_sharded_state, item_proto, make_model,
                                    make_sharded_manage_step, make_sharded_run_loop)

    S = mesh.num_shards
    T = c["T"] if S > 1 else c["c_T"]
    batches, bcounts = _sharded_stream(torch, S, T, c["b"], device=dev, rank=rank)
    sampler = _rk_sampler(scheme, c, dev, S)
    model = make_model("linreg", dim=2, device=dev)
    key = prng.key(21)
    if by_hand:
        tick = make_sharded_manage_step(sampler, model, mesh, retrain_every=RETRAIN_EVERY)

        def run(key, batches, bcounts):
            st, p = init_sharded_state(sampler, mesh, item_proto(batches)), model.init()
            rows, wc = [], []
            for t in range(bcounts.shape[0]):
                st, p, m = tick(key, t, st, p, pytree.tree_map(lambda a: a[t], batches),
                                bcounts[t])
                rows.append(m)
                wc.append((st.total_weight[0], st.weight[0]))
            trace = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
            return st, p, trace, tuple(torch.stack(x) for x in zip(*wc))
    else:
        loop = make_sharded_run_loop(sampler, model, mesh, retrain_every=RETRAIN_EVERY)

        def run(key, batches, bcounts):
            return loop(key, batches, bcounts) + (None,)
    run(key, pytree.tree_map(lambda a: a[:RETRAIN_EVERY], batches), bcounts[:RETRAIN_EVERY])
    _rk_sync(torch, dev, mesh.group is not None)
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, params, trace, wc = run(key, batches, bcounts)
    _rk_sync(torch, dev, False)
    wall = time.perf_counter() - t0
    return (state, params, trace, wall, kernels.launches(),
            (sampler, model, key), (batches, bcounts), wc)


def _rk_bank(torch, c, mesh, dev, rank):
    """Phase 18's key-sharded bank at S = 4: ``(state, params, trace, wall
    s, launches)``."""
    from repro_torch import kernels
    from repro_torch.bank import make_bank
    from repro_torch.core import prng
    from repro_torch.data.streams import KeyedStream, LinRegStream
    from repro_torch.manage import (make_model, make_sharded_bank_loop, materialize_stream,
                                    shard_keyed_stream)

    S, K = mesh.num_shards, c["K"]
    kb, kc = materialize_stream(KeyedStream(LinRegStream(seed=0), num_keys=K, alpha=1.1,
                                            flip_every=50), c["bank_T"],
                                batch_size=c["bank_b"], fields=("key", "x", "y"), device=dev)
    sb, sc = shard_keyed_stream(kb, kc, S, K, device=dev, rank=rank)
    del kb, kc
    bank = make_bank("rtbs", num_keys=K // S, n=c["bank_n"], lam=LAM_BANK, bcap=c["bank_bcap"],
                     device=dev)
    loop = make_sharded_bank_loop(bank, make_model("linreg", dim=2, device=dev), mesh,
                                  retrain_every=RETRAIN_EVERY, train_keys=range(c["Q"]))
    _rk_sync(torch, dev, mesh.group is not None)
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, params, trace = loop(prng.key(0), sb, sc)
    _rk_sync(torch, dev, False)
    return state, params, trace, time.perf_counter() - t0, kernels.launches()


def _to_cpu(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda a: a.cpu(), tree)


def _p21_ranks(device, out, small=False):
    """Phase 21 (a), (b), (d) and (f) on one rank of RK_S gloo ranks
    (``repro_torch.launch.ranks.spawn``): D-R-TBS and D-T-TBS through the
    sharded loop (rank 0 saves the gathered final state, params and trace),
    D-R-TBS's ticks by hand (W_t, C_t), rank 0's profiles of a fast and a
    retrain tick read by ``comm_analysis``, the key-sharded bank loop's
    digest; every rank writes its launches and times to ``rank<r>.json``."""
    import json

    import torch
    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from repro_torch import kernels
    from repro_torch.core import distributed
    from repro_torch.launch import comm_analysis
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.manage import make_sharded_manage_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(out)
    c = _rk_cell(small)
    mesh = make_data_mesh(c["S"], device=device, group=dist.group.WORLD)
    r, dev = mesh.rank, mesh.device
    rec = {"backend": dist.get_backend(), "device": str(dev)}
    for scheme in ("drtbs", "dttbs"):
        # D-R-TBS by hand, a tick at a time (W_t and C_t; its trace is the loop's)
        state, params, trace, wall, launches, (sampler, model, key), (batches, bcounts), wc = \
            _rk_run(torch, kernels, scheme, c, mesh, dev, r, by_hand=scheme == "drtbs")
        rec[scheme] = {"wall": wall, "launches": launches}
        if scheme == "drtbs":
            tick = make_sharded_manage_step(sampler, model, mesh, retrain_every=RETRAIN_EVERY)
            rec[scheme]["W"], rec[scheme]["C"] = (x.tolist() for x in wc)
            # (f) a fast tick and a retrain tick, rank 0 profiled
            b_t = pytree.tree_map(lambda a: a[-1], batches)
            rec["comm"] = {}
            for what, t in (("fast", c["T"]), ("retrain", 4 * RETRAIN_EVERY - 1)):
                _rk_sync(torch, dev)
                # the c10d ops are host events: no CUDA activity (CUPTI) in 4 processes
                acts = [torch.profiler.ProfilerActivity.CPU]
                with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
                    tick(key, t, state, params, b_t, bcounts[-1])
                    _rk_sync(torch, dev, False)
                if r == 0:           # a fault here is reported, and fails the phase, after
                    try:             # the other parts have run
                        rec["comm"][what] = comm_analysis.collective_stats(
                            prof, group_size=c["S"])
                    except Exception as e:     # noqa: BLE001
                        rec["comm"][what] = {"error": repr(e)}
        snap = distributed.gather_tree(state, mesh.shard_axis)
        if r == 0:
            torch.save(_to_cpu((snap, params, trace)), out / f"{scheme}.pt")
        del state, snap, batches
    state, params, trace, wall, launches = _rk_bank(torch, c, mesh, dev, r)
    rec["bank"] = {"wall": wall, "launches": launches,
                   "digest": _digest(torch, (state, params, trace), dev)}
    (out / f"rank{r}.json").write_text(json.dumps(rec))


def _p21_nccl(device, out, small=False):
    """Phase 21 (c): the D-R-TBS loop at S = 1 over an NCCL group of one
    rank (rank 0 saves its state, params and trace), then a fast tick under
    ``set_sync_debug_mode("error")``."""
    import torch
    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from repro_torch import kernels
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.manage import make_sharded_manage_step

    torch.backends.cuda.matmul.allow_tf32 = False
    c = _rk_cell(small)
    mesh = make_data_mesh(1, device=device, group=dist.group.WORLD)
    state, params, trace, wall, launches, (sampler, model, key), (batches, bcounts), _ = \
        _rk_run(torch, kernels, "drtbs", c, mesh, mesh.device, 0)
    torch.save((_to_cpu((state, params, trace)), wall, launches, dist.get_backend()),
               Path(out) / "c.pt")
    tick = make_sharded_manage_step(sampler, model, mesh, retrain_every=RETRAIN_EVERY)
    b_t = pytree.tree_map(lambda a: a[-1], batches)
    t_free = c["c_T"]
    if (t_free + 1) % RETRAIN_EVERY == 0:
        raise RuntimeError("[21] (c) the sync-check tick must not retrain")
    tick(key, t_free, state, params, b_t, bcounts[-1])          # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tick(key, t_free, state, params, b_t, bcounts[-1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _start_torchrun(args: list, env: dict, log: Path):
    """``python -m torch.distributed.run`` in a session of its own, started,
    its output to ``log``; :func:`_end_torchrun` waits for it."""
    import subprocess

    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", *args],
                                cwd=HERE, env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)


def _kill_torchrun(p) -> None:
    """End the launcher and its ranks, if it still runs: SIGTERM (the
    launcher ends its ranks, which run in sessions of their own), then
    SIGKILL to its session."""
    import os
    import signal
    import subprocess

    if p.poll() is None:
        p.terminate()
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def _end_torchrun(p, log: Path, timeout: float) -> None:
    """Wait up to ``timeout`` s for the launcher; kill it and its ranks if it
    is still running, and raise unless it exited 0."""
    import subprocess

    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill_torchrun(p)
        raise RuntimeError(f"torch.distributed.run outlived {timeout} s")
    check(p.returncode == 0, f"torch.distributed.run exited {p.returncode}:\n"
          f"{log.read_text()[-4000:]}")


_RK_DRIVE = """\
import json, os, sys
from repro_torch.launch.train import main
out, argv = sys.argv[1], sys.argv[2:]
logs = [main(argv + ["--ticks", "8", "--ckpt-dir", out + "/a"]),
        main(argv + ["--ticks", "4", "--ckpt-dir", out + "/b"]),
        main(argv + ["--ticks", "8", "--ckpt-dir", out + "/b", "--resume"])]
if os.environ["RANK"] == "0":
    with open(out + "/logs.json", "w") as f:
        json.dump(logs, f)
"""


def phase_ranks(torch, np, kernels) -> dict:
    """Phase 21: the Sec. 5 schemes with one reservoir shard a rank, against
    the stacked form on the same card: (a) D-R-TBS and (b) D-T-TBS over 4
    gloo ranks, (c) D-R-TBS over NCCL at world size 1, (d) the key-sharded
    bank over 4 gloo ranks, (e) the LM driver under torch.distributed.run,
    (f) the collectives of rank 0's profiled ticks."""
    import json
    import os
    import shutil
    import tempfile

    from repro_torch.kernels._bench import card
    from repro_torch.launch import ranks, train
    from repro_torch.launch.mesh import make_data_mesh

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    c = _rk_cell()
    S, T = c["S"], c["T"]
    dev = torch.device("cuda")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    spawn = dict(device=None, timeout=RK_TIMEOUT, path=[HERE, HERE / "src"], threads=2)
    res, launcher = {}, None
    try:
        # the stacked form at S = 4 in this process: same key, same stream
        mesh = make_data_mesh(S)
        ref = {}
        for scheme in ("drtbs", "dttbs"):
            st, p, tr, wall, launches, *_ = _rk_run(torch, kernels, scheme, c, mesh, dev, None)
            ref[scheme] = (_to_cpu((st, p, tr)), wall, launches)
            del st
        st, p, tr, bwall, _ = _rk_bank(torch, c, mesh, dev, None)
        bank_ref = [_digest(torch, _rows_of(torch, (st, p, tr), r), dev) for r in range(S)]
        del st, p, tr
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ranks.spawn("chip_smoke:_p21_ranks", S, args=(str(tmp / "a"),), log_dir=tmp / "a",
                    **spawn)
        t_abd = time.perf_counter() - t0
        per = [json.loads((tmp / "a" / f"rank{r}.json").read_text()) for r in range(S)]
        check(all(x["backend"] == "gloo" and x["device"].startswith("cuda") for x in per),
              "[21] the ranks' backend or device")
        nfit = sum((t + 1) % RETRAIN_EVERY == 0 for t in range(T))
        want = {"drtbs": {"tbs_step_apply": T, "hypergeometric": 2 * S * T,
                          "reservoir_compact": nfit, "binomial": 0},
                "dttbs": {"tbs_step_apply": T, "binomial": T, "reservoir_compact": nfit,
                          "hypergeometric": 0}}
        Cs, Ws = _drtbs_recurrence(np, [c["b"]] * T, c["n"], LAM)
        for scheme, tag in (("drtbs", "(a)"), ("dttbs", "(b)")):
            got = torch.load(tmp / "a" / f"{scheme}.pt", weights_only=False)
            (rst, rp, rtr), wall, launches = ref[scheme]
            check(_leaves_equal(torch, got, (rst, rp, rtr)),
                  f"[21] {tag} {scheme}: rank 0's gathered state, params and trace != the "
                  "stacked form's")
            for r, x in enumerate(per):
                for k, v in want[scheme].items():
                    check(x[scheme]["launches"][k] == v, f"[21] {tag} rank {r}: {k} launched "
                          f"{x[scheme]['launches'][k]} times, not {v}")
            check(launches == per[0][scheme]["launches"],
                  f"[21] {tag} the stacked run's launches {launches} != a rank's")
            rwall = max(x[scheme]["wall"] for x in per)
            res[scheme] = {"ticks_per_s_ranks": T / rwall, "ticks_per_s_stacked": T / wall,
                           "launches_per_rank": per[0][scheme]["launches"]}
            print(f"[21] {tag} {scheme} over {S} gloo ranks on one card ({card()}): n "
                  f"{c['n']}, {T} ticks of {c['b']} arrivals ({c['b'] // S} a shard); rank "
                  f"0's gathered final state, params and trace == the stacked form at S = "
                  f"{S} bit for bit; {T / rwall:.2f} ticks/s over ranks (slowest rank), "
                  f"{T / wall:.2f} ticks/s stacked; each rank's launches "
                  f"{per[0][scheme]['launches']}")
        for r, x in enumerate(per):
            for t in range(T):
                check(np.float32(x["drtbs"]["W"][t]) == Ws[t] and
                      np.float32(x["drtbs"]["C"][t]) == Cs[t],
                      f"[21] (a) rank {r} tick {t}: W, C {x['drtbs']['W'][t]!r}, "
                      f"{x['drtbs']['C'][t]!r} != {Ws[t]!r}, {Cs[t]!r}")
        print(f"[21] (a) every rank ran the loop's tick a tick at a time (its trace == the "
              f"stacked loop's); W_t and C_t == _drtbs_recurrence exactly on all {T} ticks, "
              "every rank")
        comm_errors = {w: st["error"] for w, st in per[0]["comm"].items() if "error" in st}
        for what, st in per[0]["comm"].items():
            if what not in comm_errors:
                print(f"[21] (f) rank 0's {what} tick: collectives {st['counts']}, bytes "
                      f"{ {k: int(v) for k, v in st['bytes'].items()} }")
        res["comm"] = per[0]["comm"]
        for r, x in enumerate(per):
            check(x["bank"]["digest"] == bank_ref[r],
                  f"[21] (d) rank {r}: the key-sharded bank's state, params or trace != the "
                  "stacked form's row")
            check(x["bank"]["launches"]["tbs_step_apply_banked"] == c["bank_T"],
                  f"[21] (d) rank {r}: B3 not once a tick")
        bw_r = max(x["bank"]["wall"] for x in per)
        print(f"[21] (d) key-sharded bank, K = {c['K']} over {S} gloo ranks, {c['bank_T']} "
              f"ticks of {c['bank_b']}: every rank's state, params and trace digest == the "
              f"stacked form's row; {c['bank_T'] / bw_r:.2f} ticks/s over ranks, "
              f"{c['bank_T'] / bwall:.2f} stacked; B3 once a tick a rank")
        print(f"[21] (a, b, d, f) {S} ranks took {t_abd:.1f} s from spawn to exit")
        res["bank"] = {"ticks_per_s_ranks": c["bank_T"] / bw_r,
                       "ticks_per_s_stacked": c["bank_T"] / bwall,
                       "launches_per_rank": per[0]["bank"]["launches"]}

        # (e) the driver under torch.distributed.run over 4 gloo ranks, started
        # now and run beside (c) and its one-process twin (the phase's time)
        (tmp / "e").mkdir()
        (tmp / "drive.py").write_text(_RK_DRIVE)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(HERE / "src"),
                                                           os.environ.get("PYTHONPATH", "")]),
                   GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
                   OMP_NUM_THREADS="2")
        t_e = time.perf_counter()
        launcher = _start_torchrun(["--standalone", "--nproc-per-node", str(S),
                                    str(tmp / "drive.py"), str(tmp / "e")] + RK_TRAIN_FLAGS,
                                   env, tmp / "e.log")

        # (c) NCCL at world size 1 against the stacked form at S = 1
        st, p, tr, wall, _, *_ = _rk_run(torch, kernels, "drtbs", c, make_data_mesh(1), dev,
                                         None)
        ref_c = _to_cpu((st, p, tr))
        del st
        ranks.spawn("chip_smoke:_p21_nccl", 1, args=(str(tmp / "c"),), log_dir=tmp / "c",
                    **spawn)
        got_c, cwall, _, backend = torch.load(tmp / "c" / "c.pt", weights_only=False)
        check(backend == "nccl", "[21] (c) backend")
        check(_leaves_equal(torch, got_c, ref_c),
              "[21] (c) the NCCL rank's state, params and trace != the stacked form at S = 1")
        print(f"[21] (c) drtbs over NCCL at world size 1 (cap_s {c['c_cap_s']}, {c['c_T']} "
              f"ticks): == the stacked form at S = 1 bit for bit; {c['c_T'] / cwall:.2f} "
              f"ticks/s, stacked {c['c_T'] / wall:.2f} (both beside (e)'s ranks); a fast tick "
              "ran under set_sync_debug_mode('error'): no host sync")

        t0 = time.perf_counter()
        one = train.main(RK_TRAIN_FLAGS + ["--ticks", "8", "--ckpt-dir", str(tmp / "e" / "one")])
        t_one = time.perf_counter() - t0
        _end_torchrun(launcher, tmp / "e.log", RK_TIMEOUT)
        t_e = time.perf_counter() - t_e
        full, _, resumed = json.loads((tmp / "e" / "logs.json").read_text())
        check(full == one, "[21] (e) the ranks' log != the one-process run's")
        check(resumed == full[4:], "[21] (e) the resumed ranks' log != the unbroken run's")
        ck = [(tmp / "e" / d / "step_8" / "leaves.npz").read_bytes() for d in ("a", "b", "one")]
        check(ck[0] == ck[2] and ck[1] == ck[2], "[21] (e) rank 0's step_8 checkpoint != "
              "the one-process run's, byte for byte")
        print(f"[21] (e) driver under torch.distributed.run --nproc-per-node {S} "
              f"{' '.join(RK_TRAIN_FLAGS)} (gloo): 8 ticks unbroken, 4 then "
              f"resumed to 8, in {t_e:.1f} s (3 runs, the launcher's start included, beside "
              f"(c)); logs == the one-process run's ({t_one:.1f} s), resumed == unbroken, and "
              f"step_8's checkpoint (the gathered snapshot, JAX's layout) == the one-process "
              f"run's byte for byte; eval {[round(x['eval_loss'], 4) for x in full]}")
    finally:
        if launcher is not None:     # a fault before (e) ended
            _kill_torchrun(launcher)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not comm_errors, f"[21] (f) comm_analysis on rank 0's trace: {comm_errors}")
    print(f"[21] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return res


def _rows_of(torch, tree, r: int, dim: int = 0):
    """Row ``r`` of every leaf (a shard's rows of a stacked state)."""
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda a: a.narrow(dim, r, 1), tree)


def _zoo_train_alone(torch, np, kernels) -> None:
    """Phase 20 by itself (``--only 20``): its runs, then its checks."""
    zt = ZooTrain(torch, np, kernels)
    zt.runs()
    zt.checks()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (HERE / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 linreg/NB fits
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels._bench import Timer, card
    from repro_torch.launch import hw

    PEAK.update(bfloat16=hw.PEAK_FLOPS_BF16, float32=hw.PEAK_FLOPS_F32)

    smi = card()
    name = torch.cuda.get_device_name(0)
    bw, bw_label = hbm_for(smi)
    print(f"[1] card: {smi}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}; bound bandwidth: {bw_label}; bound FLOP/s: "
          f"H100 SXM spec sheet, {PEAK['bfloat16'] / 1e12:.0f} T bf16, "
          f"{PEAK['float32'] / 1e12:.0f} T f32")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[1] built {sorted(logs)} in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1]   {src}: {line.strip()}")

    timer = Timer()
    if len(sys.argv) > 2 and sys.argv[1] == "--only":   # a subset of the new phases
        only = sys.argv[2].split(",")
        for ph, fn in (("13", lambda: phase_train(torch, np, kernels, timer, bw)),
                       ("13d", lambda: phase_train_parity(torch, np)),
                       ("14", lambda: phase_bank_train(torch, np, kernels)),
                       ("15", lambda: phase_telemetry(torch, np, kernels)),
                       ("16", lambda: phase_sharded(torch, np, kernels, timer, bw,
                                                    float("nan"))),
                       ("17", lambda: phase_zoo(torch, np, kernels, timer, bw)),
                       ("18", lambda: phase_key_sharded(torch, np, kernels)),
                       ("19", lambda: phase_dryrun(torch, np, kernels, timer)),
                       ("20", lambda: _zoo_train_alone(torch, np, kernels)),
                       ("21", lambda: phase_ranks(torch, np, kernels))):
            if ph in only:
                fn()
        print(f"chip_smoke: phases {only} only; no kernels line, no result line")
        return 0
    t_all = time.perf_counter()
    kres = phase_kernels(torch, timer, bw, reps=20)
    main_res = phase_main(torch, np, kernels, timer, bw, reps=20)
    phase_cpu_parity(torch, np)
    phase_nb(torch, np, kernels)
    bank_res = phase_bank(torch, np, kernels, timer, bw, reps=20)
    phase_bank_parity(torch, np)
    serve_res = phase_serve(torch, np, kernels, timer, bw)
    ssm_res = phase_serve_ssm(torch, np, kernels, timer, bw)
    schemes_res = phase_schemes(torch, np, kernels, timer, bw, reps=20)
    phase_schemes_parity(torch, np)
    var_res = phase_variates(torch, np, timer, bw, reps=20)
    phase_adaptive(torch, np, kernels)
    phase_adaptive_parity(torch, np)
    phase_farm(torch, np, kernels)
    tbank_res = phase_ttbs_bank(torch, np, kernels, timer, bw, reps=20)
    phase_ttbs_bank_parity(torch, np)
    t_new = time.perf_counter()
    train_res = phase_train(torch, np, kernels, timer, bw)
    phase_train_parity(torch, np)
    phase_bank_train(torch, np, kernels)
    phase_telemetry(torch, np, kernels)
    t_sh = time.perf_counter()
    shard_res = phase_sharded(torch, np, kernels, timer, bw, main_res["ticks_per_s"])
    t_zoo = time.perf_counter()
    zoo_res = phase_zoo(torch, np, kernels, timer, bw)
    t_ks = time.perf_counter()
    ks_res = phase_key_sharded(torch, np, kernels)
    t_dry = time.perf_counter()
    zt = ZooTrain(torch, np, kernels)   # phase 20, run inside phase 19's two parts
    dry_res = phase_dryrun(torch, np, kernels, timer, quiet=zt.runs, busy=zt.checks)
    t_20 = zt.t_runs + zt.t_checks
    t_21 = time.perf_counter()
    rank_res = phase_ranks(torch, np, kernels)
    print(f"[22] phases 13-15 took {t_sh - t_new:.1f} s, phase 16 {t_zoo - t_sh:.1f} s, "
          f"phase 17 {t_ks - t_zoo:.1f} s, phase 18 {t_dry - t_ks:.1f} s, phases 19 and 20 "
          f"{t_21 - t_dry:.1f} s (phase 20 {t_20:.1f} s of it), phase 21 "
          f"{time.perf_counter() - t_21:.1f} s, of {time.perf_counter() - t_all:.1f} s")

    where = {"tbs_step_apply": ("src/repro_torch/kernels/csrc/tbs_step.cu",
                                "src/repro/kernels/tbs_step/kernel.py:96"),
             "reservoir_compact": ("src/repro_torch/kernels/csrc/reservoir_compact.cu",
                                   "src/repro/kernels/reservoir_compact/kernel.py:49"),
             "swap_delete": ("src/repro_torch/kernels/csrc/swap_delete.cu",
                             "src/repro/core/latent.py:180-189"),
             "tbs_step_apply_banked": ("src/repro_torch/kernels/csrc/tbs_step_banked.cu",
                                       "src/repro/kernels/tbs_step/kernel.py:64"),
             "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                                 "src/repro/kernels/flash_attention/kernel.py:73"),
             "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
                          "src/repro/kernels/ssd_scan/kernel.py:66"),
             "binomial": ("src/repro_torch/kernels/csrc/variates.cu",
                          "src/repro/core/rng.py:20"),
             "hypergeometric": ("src/repro_torch/kernels/csrc/variates.cu",
                                "src/repro/core/rng.py:42")}
    kres["tbs_step_apply"]["main_tick_map_ms"] = main_res["b1_tick_ms"]
    kres["tbs_step_apply_banked"] = bank_res["b3"]
    kres["flash_attention"] = serve_res["b4"]
    kres["ssd_scan"] = ssm_res["b5"]
    kres.update(var_res)
    # H2 at the T-TBS bank's shape (2b rows a tick) and B3 at its cap 256,
    # beside the rows' own numbers (a T-TBS tick's 2 rows; the R-TBS bank)
    h2 = tbank_res["h2"]
    kres["binomial"]["ttbs_bank"] = {k: h2[k] for k in (
        "rows", "launches", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "trips", "live_rows", "live_bound_ms", "empty_launch_ms")}
    kres["tbs_step_apply_banked"]["ttbs_bank"] = {
        "cap": tbank_res["b3"]["cap"], "launches": tbank_res["launches"]["tbs_step_apply_banked"],
        "ms": tbank_res["b3"]["ms"], "bound_ms": tbank_res["b3"]["bound_ms"],
        "max_abs_err": tbank_res["b3"]["err"]}
    # each kernel's launches from the run of the path it carries
    runs = dict(main_res["launches"], tbs_step_apply_banked=bank_res["launches"][
        "tbs_step_apply_banked"], flash_attention=serve_res["launches"]["flash_attention"],
        ssd_scan=ssm_res["launches"]["ssd_scan"],
        binomial=schemes_res["ttbs"]["launches"]["binomial"],
        hypergeometric=schemes_res["brs"]["launches"]["hypergeometric"])
    rows = []
    for k, r in kres.items():
        rows.append({"name": k, "route": "cuda", "source": where[k][0],
                     "replaces": where[k][1], "launches": runs[k],
                     "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r.get("bound_by", "bytes"),
                     "library_ms": r["library_ms"]})
        if "shapes" in r:
            rows[-1]["shapes"] = r["shapes"]
        if "bound_counts" in r:         # B2's row: what its byte bound counts
            rows[-1]["bound_counts"] = r["bound_counts"]
        if "main_tick_map_ms" in r:     # B1's row: ms is phase 2's uniform map
            rows[-1]["main_tick_map_ms"] = r["main_tick_map_ms"]
        if "chain_floor_ms" in r:       # H3's row: computed, as bound_ms is, from this
            rows[-1]["chain_floor_ms"] = r["chain_floor_ms"]   # run's trips and top SM clock
        if "ttbs_bank" in r:            # H2's and B3's rows: the T-TBS bank's shape
            rows[-1]["ttbs_bank"] = r["ttbs_bank"]
    # B4's f32 calls build from their own source; the row's numbers are the
    # bf16 route's, the one the served prefill runs
    rows[list(kres).index("flash_attention")]["f32_route"] = {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "max_abs_err": kres["flash_attention"]["f32_err"]}
    # so are B5's, timed on the prefill's shape in f32
    rows[list(kres).index("ssd_scan")]["f32_route"] = {
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "max_abs_err": kres["ssd_scan"]["f32_err"], "ms": kres["ssd_scan"]["f32_ms"]}
    # B5 at the LM driver's fit shape, and its launches over phase 13's run
    rows[list(kres).index("ssd_scan")]["train"] = train_res["b5_train"]
    rows[list(kres).index("tbs_step_apply")]["train_launches"] = train_res["b1_launches"]
    # the driver on granite_moe_3b and zamba2_2p7b (phase 20): B1 once a
    # tick; zamba2's B5 launches, forwards and recomputes
    by_arch = {a["arch"]: a for a in zt.res}
    rows[list(kres).index("tbs_step_apply")]["zoo_train_launches"] = {
        k: v["b1"] for k, v in by_arch.items()}
    rows[list(kres).index("ssd_scan")]["zoo_train"] = {
        "arch": "zamba2_2p7b", "ticks": ZOO_TRAIN_TICKS,
        "launches": by_arch["zamba2_2p7b"]["b5"],
        "recompute_launches": by_arch["zamba2_2p7b"]["b5_recompute"]}
    # launches on the sharded path (phase 16): D-R-TBS's 48 ticks at 8 shards
    # (B1, H3, B2), D-T-TBS's (H2)
    sh = shard_res["launches"]
    for k, n_, path in (("tbs_step_apply", sh["tbs_step_apply"], "drtbs"),
                        ("reservoir_compact", sh["reservoir_compact"], "drtbs"),
                        ("hypergeometric", sh["hypergeometric"], "drtbs"),
                        ("binomial", shard_res["dttbs_launches"]["binomial"], "dttbs")):
        rows[list(kres).index(k)]["sharded"] = {"launches": n_, "ticks": SH_T,
                                                "shards": SH_S, "scheme": path}
    # the rank form (phase 21): each of 4 gloo ranks' launches over the same 48
    # ticks (B1, H3, B2 for drtbs; H2 for dttbs), and B3's over the bank's
    rl = {s_: rank_res[s_]["launches_per_rank"] for s_ in ("drtbs", "dttbs")}
    for k, path in (("tbs_step_apply", "drtbs"), ("reservoir_compact", "drtbs"),
                    ("hypergeometric", "drtbs"), ("binomial", "dttbs")):
        rows[list(kres).index(k)]["ranks"] = {
            "launches_per_rank": rl[path][k], "ticks": SH_T, "ranks": RK_S, "backend": "gloo",
            "scheme": path}
    rows[list(kres).index("tbs_step_apply_banked")]["ranks"] = {
        "launches_per_rank": rank_res["bank"]["launches_per_rank"]["tbs_step_apply_banked"],
        "ticks": _rk_cell()["bank_T"], "ranks": RK_S, "backend": "gloo"}
    # B3 on the key-sharded bank loop (phase 18): one launch a tick for all shards
    rows[list(kres).index("tbs_step_apply_banked")]["key_sharded"] = {
        "launches": ks_res["launches"], "ticks": T_BANK, "shards": KS_S,
        "rows_routed": ks_res["rows"], "bcap_s": ks_res["bcap_s"]}
    # the rest of the LM zoo (phase 17): each cell's B4 / B5 launches a
    # prefill, and the kernels at its served shapes
    zoo_launches = {c["arch"]: {"flash_attention": c["b4"], "ssd_scan": c["b5"]}
                    for c in zoo_res["cells"]}
    rows[list(kres).index("flash_attention")]["lm_zoo"] = {
        "prefill_launches": {a: n["flash_attention"] for a, n in zoo_launches.items()},
        "shapes": zoo_res["b4"], "f32_max_abs_err": zoo_res["b4_f32_err"]}
    rows[list(kres).index("ssd_scan")]["lm_zoo"] = {
        "prefill_launches": {a: n["ssd_scan"] for a, n in zoo_launches.items() if n["ssd_scan"]},
        "shapes": [zoo_res["b5"]]}
    # B4 and B5 through their registered ops (phase 19): host ms a call, and
    # their launches in each cut cell run on the card against the dry run
    for k, tag in (("flash_attention", "b4"), ("ssd_scan", "b5")):
        rows[list(kres).index(k)]["registered_op"] = {
            "bit_equal_to_direct_launch": all(v for kk, v in dry_res["ops"].items()
                                              if kk.startswith(tag) and kk.endswith("_equal")),
            "host_ms": dry_res["ops"][f"{tag}_host_ms"],
            "dryrun_cells": {name: {d: r[d]["launches"].get(k, 0) for d in ("l1", "l2")}
                             for name, r in dry_res["checks"].items()}}
    print(json.dumps({"kernels": rows}))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
