"""Online model management driver (the paper's loop, lifted to LMs):

  stream -> time-biased sample update -> periodic retraining on the current
  sample -> prequential evaluation -> checkpoint.

The port of the JAX package's ``launch/train.py``: the same flags and the
same printed lines. It runs on the CUDA card unless ``device="cpu"`` is
passed to :func:`main`. The sampler is any local scheme of the registry
(``--scheme rtbs|sw|brs|btbs|ttbs``, see :mod:`repro_torch.core.api`);
retraining runs through the SGD adapter
(:func:`repro_torch.manage.make_sgd_adapter`) over
:func:`repro_torch.train.steps.make_train_step` (next-token cross entropy,
AdamW), under ``cfg.remat`` (JAX's default: each block checkpointed and
recomputed in the backward). The archs fed ``tokens`` alone train: dense,
MoE (``granite_moe_3b``), Mamba2 and the hybrid (``zamba2_2p7b``); vlm and
audio need frontend embeddings, as in JAX. Mamba2 and hybrid archs run
kernel B5 in every forward, eval and fit alike, and again in each
recompute (its backward is the plain chunked form's gradient); the
sampler's tick runs B1. ``--resume`` restarts bit for bit from the newest checkpoint (params,
optimizer, reservoir, controller, stream position): the stream, the keys and
every kernel on the path are deterministic.

Distributed schemes (``--scheme drtbs|dttbs``, paper Sec. 5): the run goes
through the sharded loop (:func:`run_sharded`) over ``--shards`` reservoir
shards (default 8; local schemes ignore it), kept as a leading dimension
of one card's state. Under ``python -m torch.distributed.run
--nproc-per-node S`` (``WORLD_SIZE`` set) each rank holds one shard
instead (:mod:`repro_torch.launch.ranks`; ``--shards`` must equal the
world size; the backend is gloo where the ranks outnumber the cards, which
NCCL refuses, else NCCL), the port's counterpart of JAX's re-exec over S devices;
rank 0 prints and writes the checkpoints and telemetry, and every rank's
state is row ``rank`` of the one-process run's. The tick batch is padded to
a multiple of the shard count; ``--ckpt-dir`` consumes the stream in
checkpointed segments through
:func:`repro_torch.manage.make_sharded_resume_loop` (the gathered snapshot,
JAX's layout) and ``--resume`` continues them bit for bit.

Decay: ``--decay exp`` (default; rate ``--lam``) or ``--decay poly``
(power-law, exponent ``--beta``); ``--adaptive`` switches to the
closed-loop controller (lambda driven by the prequential loss between
``--lam-min`` and ``--lam-max``, starting at ``--lam``).

Multi-tenant mode: ``--num-keys K`` swaps the single sampler for a
:class:`repro_torch.bank.SamplerBank` -- K per-key time-biased samples over
a Zipf-keyed token stream with per-key drift phases, advanced by the bank's
key-routed step (kernel B3); the LM retrains on the pooled extract of the
``--train-keys`` most popular keys (rtbs/ttbs only), through
:func:`repro_torch.manage.make_bank_run_loop`.

Telemetry: ``--telemetry-dir`` / ``--telemetry-stdout`` write one
``kind="tick"`` record a tick (``--telemetry-every`` is the bank loop's
drain period). ``--profile-dir`` writes a ``torch.profiler`` trace of the
first ``--profile-ticks`` ticks (the whole bank run in bank mode).

Examples (on the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_370m \\
      --preset full --seq-len 512 --batch-per-tick 64 --reservoir 4096 \\
      --retrain-every 4 --retrain-steps 8 --train-batch 16 --ticks 12 \\
      --drift none --ckpt-dir runs/ck --ckpt-every 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_moe_3b \\
      --preset full --seq-len 512 --batch-per-tick 64 --reservoir 4096 \\
      --retrain-every 4 --retrain-steps 8 --train-batch 16 --ticks 8 \\
      --drift none --lr 3e-4      # also --arch zamba2_2p7b
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_370m \\
      --preset smoke --ticks 20 --scheme rtbs --num-keys 4096 --train-keys 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_370m \\
      --preset smoke --ticks 12 --scheme drtbs --shards 8 --retrain-every 4
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --arch mamba2_370m \\
      --preset smoke --ticks 12 --scheme drtbs --shards 4
"""
from __future__ import annotations

import argparse
import contextlib
import math
import time

import torch
from torch.utils import _pytree as pytree

from repro_torch import _device, convert
from repro_torch import config as C
from repro_torch import decay as dk
from repro_torch.bank import make_bank
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.core import distributed, prng
from repro_torch.core.api import available_schemes, make_sampler
from repro_torch.data.streams import KeyedStream, TokenDriftStream, mode_schedule
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.manage import (
    init_sharded_state, item_proto, make_bank_run_loop, make_sgd_adapter,
    make_sharded_resume_loop, make_sharded_run_loop, materialize_stream, shard_stream,
)
from repro_torch.models import zoo
from repro_torch.obs import make_telemetry, profile_span
from repro_torch.obs import probe as obs_probe
from repro_torch.obs.profile import scope
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step

DISTRIBUTED_SCHEMES = ("drtbs", "dttbs")
DECAY_FREE_SCHEMES = ("sw", "brs")


def build_sampler(scheme: str, *, n: int, lam: float, batch_per_tick: int,
                  shards: int = 1, decay=None, device=None):
    """Map the driver's knobs onto each scheme's hyperparameters. ``decay``
    (a DecaySchedule) replaces the scalar ``lam`` when given; ``lam`` still
    sizes the B-TBS capacity bound. ``shards`` sizes the distributed
    schemes."""
    dkw = {"lam": lam} if decay is None else {"decay": decay}
    if scheme == "rtbs":
        return make_sampler("rtbs", n=n, device=device, **dkw)
    if scheme in DECAY_FREE_SCHEMES:
        return make_sampler(scheme, n=n, device=device)
    if scheme == "btbs":
        # B-TBS has NO size control (paper Alg. 4): steady-state E|S| is
        # b/(1-e^-lam), not --reservoir. Provision 3x that so the capacity
        # bound never silently distorts the time bias.
        steady = batch_per_tick / max(1.0 - math.exp(-lam), 1e-6)
        return make_sampler("btbs", cap=max(n, int(3 * steady) + 1), device=device, **dkw)
    if scheme == "ttbs":
        return make_sampler("ttbs", n=n, batch_size=batch_per_tick, device=device, **dkw)
    if scheme == "drtbs":
        # cap_s covers the worst transient: every global full item plus this
        # shard's incoming batch landing on one shard before the downsample
        return make_sampler("drtbs", n=n, cap_s=n + batch_per_tick, device=device, **dkw)
    if scheme == "dttbs":
        # per-shard targets: n/S sample rows fed by b/S arrivals per shard
        n_s = max(1, -(-n // shards))
        b_s = max(1.0, batch_per_tick / shards)
        return make_sampler("dttbs", n=n_s, batch_size=b_s, device=device, **dkw)
    raise ValueError(f"unsupported scheme {scheme!r}; see {available_schemes()}")


def build_decay(args):
    """(DecaySchedule | None for the lam sugar, AdaptiveDecay | None)."""
    if args.scheme in DECAY_FREE_SCHEMES:
        if args.adaptive or args.decay != "exp":
            raise SystemExit(f"--scheme {args.scheme} has no decay to configure")
        return None, None
    controller = None
    if args.adaptive:
        lam_min = args.lam_min if args.lam_min is not None else args.lam / 20
        lam_max = args.lam_max if args.lam_max is not None else min(1.5, args.lam * 20)
        controller = dk.loss_ratio(lam0=args.lam, lam_min=lam_min, lam_max=lam_max)
    sched = dk.polynomial(args.beta) if args.decay == "poly" else None
    return sched, controller


def build_telemetry(args):
    """The run's :class:`repro_torch.obs.Telemetry` from the CLI knobs (None
    when telemetry is off)."""
    if not (args.telemetry_dir or args.telemetry_stdout):
        return None
    return make_telemetry(args.telemetry_dir, stdout=args.telemetry_stdout,
                          every=args.telemetry_every)


def profile_cm(args):
    """A profiler span over whatever it wraps (the bank run)."""
    if not args.profile_dir:
        return contextlib.nullcontext()
    return profile_span(args.profile_dir)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_12b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the architecture's depth to this many layers "
                         "(its widths unchanged)")
    ap.add_argument("--scheme", default="rtbs",
                    choices=["rtbs", "sw", "brs", "btbs", "ttbs", "drtbs", "dttbs"])
    ap.add_argument("--shards", type=int, default=8,
                    help="reservoir shards of the distributed schemes (a leading "
                         "dimension of one card's state, or one a rank under "
                         "torch.distributed.run); local schemes ignore it")
    ap.add_argument("--num-keys", type=int, default=0,
                    help="multi-tenant mode: maintain one per-key time-biased "
                         "sample for this many entities (repro_torch.bank; "
                         "rtbs/ttbs only)")
    ap.add_argument("--train-keys", type=int, default=8,
                    help="bank mode: retrain on / log the pooled sample of "
                         "this many most-popular keys")
    ap.add_argument("--bank-bcap", type=int, default=None,
                    help="bank mode: static per-key sub-batch capacity "
                         "(default: the whole tick batch, no routing drops)")
    ap.add_argument("--ticks", type=int, default=30)
    ap.add_argument("--batch-per-tick", type=int, default=32)
    ap.add_argument("--reservoir", type=int, default=256)
    ap.add_argument("--lam", type=float, default=0.07)
    ap.add_argument("--decay", default="exp", choices=["exp", "poly"],
                    help="decay schedule: exp (rate --lam) or poly "
                         "(power-law, exponent --beta)")
    ap.add_argument("--beta", type=float, default=0.8,
                    help="polynomial-decay exponent (--decay poly)")
    ap.add_argument("--adaptive", action="store_true",
                    help="closed-loop decay: drive lambda from the prequential "
                         "loss (starts at --lam, clipped to [--lam-min, --lam-max])")
    ap.add_argument("--lam-min", type=float, default=None)
    ap.add_argument("--lam-max", type=float, default=None)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--retrain-every", type=int, default=5)
    ap.add_argument("--superbatch", type=int, default=None,
                    help="accepted for the JAX package's flags; changes nothing")
    ap.add_argument("--retrain-steps", type=int, default=8)
    ap.add_argument("--train-batch", type=int, default=16)
    ap.add_argument("--drift", default="periodic", choices=["periodic", "single", "none"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--telemetry-dir", default=None,
                    help="write telemetry (one JSONL record per tick + "
                         "health-monitor warnings) under this directory")
    ap.add_argument("--telemetry-every", type=int, default=64,
                    help="telemetry drain period in ticks (bank mode)")
    ap.add_argument("--telemetry-stdout", action="store_true",
                    help="echo telemetry records to stdout")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace (Chrome/Perfetto JSON) "
                         "under this directory")
    ap.add_argument("--profile-ticks", type=int, default=8,
                    help="per-tick driver: ticks to bracket with the profiler "
                         "(bank mode profiles the whole run)")
    return ap.parse_args(argv)


def build_model(args, device, cfg=None):
    """(cfg, api, adapter) for the run's arch, or for ``cfg`` when given (a
    caller's variant of the arch's config, e.g. with ``remat=False``). The
    LR schedule's horizon is fixed: it must NOT depend on --ticks, or an
    interrupted run would train under a different curve than the run it
    resumes."""
    if cfg is None:
        cfg = (C.get_smoke_config(args.arch) if args.preset == "smoke"
               else C.get_config(args.arch))
    if args.layers is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    api = zoo.build(cfg)
    adapter = make_sgd_adapter(
        init_params=lambda: api.init_params(args.seed, device=device),
        train_step=make_train_step(api, AdamWConfig(lr=args.lr), microbatches=1,
                                   warmup=2, total_steps=4000),
        init_opt_state=adamw_init,
        loss=api.loss,
        batch_field="tokens",
        train_batch=args.train_batch,
        retrain_steps=args.retrain_steps,
        name=args.arch,
        device=device,
    )
    return cfg, api, adapter


def _log_sharded_trace(trace, t0, mode_of, log, telemetry=None, echo=True):
    metric = trace["metric"].cpu().numpy()
    size = trace["size"].cpu().numpy()
    dec = trace["decay"].cpu().numpy() if "decay" in trace else None
    for i in range(len(size)):
        t = t0 + i
        row = {"tick": t, "mode": mode_of(t), "eval_loss": float(metric[i]),
               "sample_size": int(size[i])}
        extra = ""
        if dec is not None:
            row["lam"] = float(-math.log(max(float(dec[i]), 1e-30)))
            extra = f" lam={row['lam']:6.4f}"
        log.append(row)
        if telemetry is not None:   # the checkpointed path: host-side records
            telemetry.emit({"kind": "tick", "t": t, "metric": float(metric[i]),
                            "size": int(size[i]),
                            **({"decay": float(dec[i])} if dec is not None else {})})
        if echo:
            print(f"[train] tick={t:4d} mode={mode_of(t)} eval={float(metric[i]):7.4f} "
                  f"|S|={int(size[i]):5d}{extra}", flush=True)
    if telemetry is not None:
        telemetry.flush()


def _sampler_first(tree: tuple) -> tuple:
    """The driver's checkpoint tree with its first two entries swapped: the
    sharded run saves ``(sampler state, sgd state, ...)``, as JAX's does."""
    return (tree[1], tree[0]) + tuple(tree[2:])


def run_sharded(args, adapter, cfg, sampler, controller, device, group=None):
    """The Sec. 5 path: every tick's batch co-partitioned over ``--shards``
    shards, then stream -> per-shard sample update -> periodic retrain on
    the global view -> prequential eval through the sharded loop, over one
    card's stacked shards or, with ``group``, one shard a rank. Without
    ``--ckpt-dir`` the stream is one run of
    :func:`repro_torch.manage.make_sharded_run_loop`; with it, the stream
    is consumed in ``--ckpt-every``-tick segments (rounded up to the retrain
    cadence) through :func:`repro_torch.manage.make_sharded_resume_loop`,
    the gathered snapshot saved after each (all-gathered, written by rank
    0), and ``--resume`` restarts bit for bit (every rank restores its rows
    of the snapshot)."""
    S, dev = args.shards, device
    # main() rounded batch_per_tick up to a multiple of S: the sampler's
    # rates and the padding-free shard segments both depend on it
    assert args.batch_per_tick % S == 0
    stream = TokenDriftStream(seed=args.seed, vocab=cfg.vocab_size, seq_len=args.seq_len)

    def mode_of(t):
        return 0 if args.drift == "none" else mode_schedule(args.drift, t)

    mesh = make_data_mesh(S, device=dev, group=group)
    lead = mesh.rank == 0            # prints, checkpoints, telemetry and profiles
    batches, bcounts = materialize_stream(stream, args.ticks, batch_size=args.batch_per_tick,
                                          mode=mode_of, device=dev)
    batches, bcounts = shard_stream(batches, bcounts, S, device=dev,
                                    rank=None if group is None else mesh.rank)
    form = f"{S} shards" if group is None else f"{S} ranks, one shard each"
    key = prng.key(args.seed)
    log = []
    telemetry = build_telemetry(args) if lead else None
    if not args.ckpt_dir:
        run = make_sharded_run_loop(sampler, adapter, mesh, retrain_every=args.retrain_every,
                                    superbatch=args.superbatch, controller=controller,
                                    telemetry=telemetry)
        if lead:
            print(f"[train] sharded {args.scheme} loop: {form}, {args.ticks} ticks, "
                  "one run", flush=True)
        with profile_cm(args) if lead else contextlib.nullcontext():
            _, _, trace = run(key, batches, bcounts)
        _log_sharded_trace(trace, 0, mode_of, log, echo=lead)
        if telemetry is not None:
            telemetry.close()
        return log

    seg = -(-args.ckpt_every // args.retrain_every) * args.retrain_every
    resume = make_sharded_resume_loop(sampler, adapter, mesh, retrain_every=args.retrain_every,
                                      superbatch=args.superbatch, controller=controller)
    state = init_sharded_state(sampler, mesh, item_proto(batches))
    params = adapter.init()
    cstate = controller.init(dev) if controller is not None else None
    start_tick = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir)
    if args.resume:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            like = _sampler_first(convert.train_checkpoint_like(params, state, cstate))
            tree = restore_checkpoint(args.ckpt_dir, last, like)
            params, state, cstate, start_tick = convert.train_checkpoint_from_numpy(
                cfg, _sampler_first(tree), device=dev)
            state = distributed.local_rows(state, mesh.shard_axis)
            if lead:
                print(f"[train] resumed sharded run from step {last} (tick {start_tick})")
    if lead:
        print(f"[train] sharded {args.scheme} loop: {form}, {args.ticks} ticks, "
              f"{seg}-tick checkpointed segments", flush=True)
    if telemetry is not None:
        telemetry.open_run({"scheme": args.scheme, "ticks": args.ticks, "segment": seg,
                            "every": telemetry.every, "backend": dev.type, "jax": None,
                            "torch": torch.__version__, "state_bytes": None})

    def cut(tree, lo, hi):
        return pytree.tree_map(lambda a: a[lo:hi], tree)

    for t0 in range(start_tick, args.ticks, seg):
        t1 = min(t0 + seg, args.ticks)
        aux = () if controller is None else (cstate,)
        state, params, *aux, trace = resume(key, state, params, *aux, cut(batches, t0, t1),
                                            bcounts[t0:t1], t0)
        cstate = aux[0] if aux else None
        _log_sharded_trace(trace, t0, mode_of, log, telemetry=telemetry, echo=lead)
        # only retrain-aligned ticks are resume points (the resume loop
        # requires t0 % G == 0, G | retrain_every): a misaligned final
        # segment is not saved, and a later --resume replays it
        if t1 % args.retrain_every == 0:
            snap = distributed.gather_tree(state, mesh.shard_axis)
            if lead:
                ckpt.save(t1, _sampler_first(
                    convert.train_checkpoint_to_numpy(params, snap, cstate, t1)))
    ckpt.wait()
    if group is not None:            # every checkpoint is on disk before any rank returns
        torch.distributed.barrier(group=group)
    if telemetry is not None:
        telemetry.close()
    return log


def run_bank(args, adapter, cfg, device):
    """Multi-tenant mode (``--num-keys``): one
    :class:`repro_torch.bank.SamplerBank` keeps a per-key time-biased sample
    for every entity; the shared LM retrains on the pooled extract of the
    ``--train-keys`` most popular keys, through
    :func:`repro_torch.manage.make_bank_run_loop` over a Zipf-keyed token
    stream with per-key drift phases."""
    if args.ckpt_dir or args.resume:
        raise SystemExit("--num-keys has no checkpoint/resume path yet (ROADMAP A "
                         "item 3); drop --ckpt-dir/--resume for bank runs")
    K, Q = args.num_keys, min(args.train_keys, args.num_keys)
    stream = KeyedStream(
        base=TokenDriftStream(seed=args.seed, vocab=cfg.vocab_size, seq_len=args.seq_len),
        num_keys=K, seed=args.seed,
        flip_every=0 if args.drift == "none" else 5 * args.retrain_every,
    )
    batches, bcounts = materialize_stream(stream, args.ticks, batch_size=args.batch_per_tick,
                                          fields=("key", "tokens"), device=device)
    bcap = args.bank_bcap or args.batch_per_tick
    sched, controller = build_decay(args)
    if controller is not None:
        raise SystemExit("--adaptive drives per-key farms "
                         "(manage.make_bank_run_loop(per_key=True)); the "
                         "shared-model --num-keys driver runs the bank's own schedule")
    dkw = {"lam": args.lam} if sched is None else {"decay": sched}
    if args.scheme == "rtbs":
        bank = make_bank("rtbs", num_keys=K, n=args.reservoir, bcap=bcap, device=device,
                         **dkw)
    elif args.scheme == "ttbs":
        bank = make_bank("ttbs", num_keys=K, n=args.reservoir,
                         batch_size=max(1.0, args.batch_per_tick / K), bcap=bcap,
                         device=device, **dkw)
    else:
        raise SystemExit(f"--num-keys supports the local time-biased schemes rtbs/ttbs; "
                         f"got --scheme {args.scheme}")
    telemetry = build_telemetry(args)
    run = make_bank_run_loop(bank, adapter, retrain_every=args.retrain_every,
                             train_keys=range(Q), superbatch=args.superbatch,
                             telemetry=telemetry)
    print(f"[train] bank {args.scheme} loop: K={K} keys, top-{Q} trained, "
          f"{args.ticks} ticks, one loop", flush=True)
    with profile_cm(args):
        state, _, trace = run(prng.key(args.seed), batches, bcounts)
    metric = trace["metric"].cpu().numpy()
    sizes = trace["size"].cpu().numpy()
    overflow = trace["overflow"].cpu().numpy()
    log = []
    for t in range(args.ticks):
        log.append({"tick": t, "eval_loss": float(metric[t]),
                    "train_key_sizes": [int(s) for s in sizes[t]],
                    "overflow": int(overflow[t])})
        print(f"[train] tick={t:4d} eval={float(metric[t]):7.4f} "
              f"|S|(top-{Q})={sizes[t].tolist()}", flush=True)
    ov = int(state.overflow.sum())
    print(f"[train] bank done: routed-overflow={ov} items (per-key bcap={bcap})", flush=True)
    if telemetry is not None:
        telemetry.close()
    return log


class LocalRun:
    """The per-tick driver (JAX's ``main`` loop body) as an object: its
    state, and :meth:`tick`, which runs one tick and returns its log row.
    ``main`` drives it; a caller may drive (and profile) ticks itself."""

    def __init__(self, args, device=None):
        self.args = args
        self.dev = dev = _device.resolve(device)
        self.cfg, self.api, self.adapter = build_model(args, dev)
        self.stream = TokenDriftStream(seed=args.seed, vocab=self.cfg.vocab_size,
                                       seq_len=args.seq_len)
        sched, self.controller = build_decay(args)
        self.sampler = build_sampler(args.scheme, n=args.reservoir, lam=args.lam,
                                     batch_per_tick=args.batch_per_tick, decay=sched,
                                     device=dev)
        self.st = self.sampler.init(torch.zeros((args.seq_len,), dtype=torch.int32,
                                                device=dev))
        self.model_state = self.adapter.init()
        self.cstate = self.controller.init(dev) if self.controller is not None else None
        self.bcount = torch.tensor(args.batch_per_tick, dtype=torch.int64, device=dev)
        self.start_tick = 0
        self.last_fit_s = None      # wall seconds of the last retrain's fit
        self.telemetry = build_telemetry(args)
        self.state_stats = obs_probe.make_state_stats(self.sampler)
        self.d_static = obs_probe.static_decay(self.sampler)

    def resume(self) -> None:
        """Restore the newest checkpoint under ``--ckpt-dir``, if any."""
        last = latest_step(self.args.ckpt_dir)
        if last is None:
            return
        like = convert.train_checkpoint_like(self.model_state, self.st, self.cstate)
        tree = restore_checkpoint(self.args.ckpt_dir, last, like)
        self.model_state, self.st, self.cstate, self.start_tick = \
            convert.train_checkpoint_from_numpy(self.cfg, tree, device=self.dev)
        print(f"[train] resumed from step {last} (tick {self.start_tick})")

    def open_telemetry(self) -> None:
        if self.telemetry is not None:
            self.telemetry.open_run({"scheme": self.args.scheme, "ticks": self.args.ticks,
                                     "superbatch": 1, "every": self.telemetry.every,
                                     "backend": self.dev.type, "jax": None,
                                     "torch": torch.__version__,
                                     "state_bytes": obs_probe.tree_nbytes(self.st)})

    def tick(self, t: int) -> dict:
        args, dev = self.args, self.dev
        mode = 0 if args.drift == "none" else mode_schedule(args.drift, t)
        batch = torch.from_numpy(self.stream.batch(t, args.batch_per_tick, mode)).to(dev)
        retrain = (t + 1) % args.retrain_every == 0

        # prequential eval BEFORE the model sees this data
        with scope("manage.eval"):
            eval_loss = float(self.adapter.evaluate(self.model_state, batch,
                                                    args.batch_per_tick))

        # sample update; with --adaptive the controller's current rate drives
        # the step and the prequential loss feeds back (adjustment gated on
        # retrain ticks, as in the loop)
        key_t = prng.fold_in(prng.key(args.seed + 1), t)
        with scope("manage.sampler_step"):
            if self.controller is not None:
                d_t = self.controller.rate(self.cstate)
                self.st = self.sampler.step_decayed(key_t, self.st, batch, self.bcount, d_t)
                self.cstate = self.controller.observe(
                    self.cstate, torch.tensor(eval_loss, dtype=torch.float32, device=dev),
                    retrain)
            else:
                self.st = self.sampler.step(key_t, self.st, batch, self.bcount)

        # ONE realization per tick: the logged |S| is the sample fit trains on
        k_ex, k_fit = prng.split(prng.fold_in(prng.key(args.seed + 2), t), 2)
        with scope("manage.size"):
            view = self.sampler.extract(k_ex, self.st)
            size = int(view.size)

        # periodic retraining on the realized time-biased sample
        train_loss = float("nan")
        if retrain and size >= args.train_batch:
            t0 = time.perf_counter()
            with scope("manage.retrain"):
                self.model_state = self.adapter.fit(k_fit, self.model_state, view)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.last_fit_s = time.perf_counter() - t0
            with scope("manage.eval"):
                train_loss = float(self.adapter.evaluate(self.model_state, batch,
                                                         args.batch_per_tick))

        # every scheme's state carries W_t (decayed weight for rtbs/ttbs/btbs,
        # item count for brs/sw); time-varying schedules wrap it
        raw = self.st.inner if isinstance(self.st, dk.DecayedState) else self.st
        total_w = float(raw.total_weight)
        row = {"tick": t, "mode": mode, "eval_loss": eval_loss, "train_loss": train_loss,
               "sample_size": size, "total_weight": total_w}
        extra = ""
        if self.controller is not None:
            row["lam"] = float(self.cstate.lam)
            extra = f" lam={row['lam']:6.4f}"
        if self.telemetry is not None:
            rec = {"kind": "tick", "t": t, "bcount": args.batch_per_tick,
                   "metric": eval_loss, "size": size, "retrain": retrain}
            rec.update({k: float(v) for k, v in self.state_stats(self.st).items()})
            if self.controller is not None:
                rec["decay"] = float(d_t)
                rec["lam"] = row["lam"]
            elif self.d_static is not None:
                rec["decay"] = self.d_static
            self.telemetry.emit(rec)
        print(f"[train] tick={t:4d} mode={mode} eval={eval_loss:7.4f} "
              f"train={train_loss:7.4f} |S|={size:5d} W={total_w:8.2f}{extra}", flush=True)
        return row

    def checkpoint_tree(self, tick: int) -> tuple:
        """The checkpoint of the state after ``tick`` ticks, in JAX's layout
        (host copies)."""
        return convert.train_checkpoint_to_numpy(self.model_state, self.st, self.cstate, tick)


def main(argv=None, device=None):
    args = parse_args(argv)
    if args.scheme in DISTRIBUTED_SCHEMES:
        if args.shards < 1:
            raise SystemExit(f"--shards must be at least 1; got {args.shards}")
        # pad the tick batch to a multiple of the shards BEFORE the sampler
        # is built: dttbs calibrates its rates on the per-shard arrivals, and
        # the SGD adapter's loss needs padding-free shard segments
        b = -(-args.batch_per_tick // args.shards) * args.shards
        if b != args.batch_per_tick:
            print(f"[train] batch-per-tick {args.batch_per_tick} -> {b} "
                  f"(multiple of {args.shards} shards)")
            args.batch_per_tick = b
    if args.num_keys:
        dev = _device.resolve(device)
        cfg, _, adapter = build_model(args, dev)
        return run_bank(args, adapter, cfg, dev)
    if args.scheme in DISTRIBUTED_SCHEMES:
        group = None
        if ranks.launched():         # one shard a rank (torch.distributed.run)
            import torch.distributed as dist

            dev = ranks.init(device=device)
            if args.shards != dist.get_world_size():
                raise SystemExit(f"--shards {args.shards} under a launcher of "
                                 f"{dist.get_world_size()} ranks: one shard a rank")
            group = dist.group.WORLD
        else:
            dev = _device.resolve(device)
        cfg, _, adapter = build_model(args, dev)
        sched, controller = build_decay(args)
        sampler = build_sampler(args.scheme, n=args.reservoir, lam=args.lam,
                                batch_per_tick=args.batch_per_tick, shards=args.shards,
                                decay=sched, device=dev)
        return run_sharded(args, adapter, cfg, sampler, controller, dev, group)

    run = LocalRun(args, device)
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir:
        run.resume()
    run.open_telemetry()
    prof = contextlib.ExitStack()
    log = []
    for t in range(run.start_tick, args.ticks):
        if args.profile_dir and t == run.start_tick:
            prof.enter_context(profile_span(args.profile_dir))
        if args.profile_dir and t == run.start_tick + args.profile_ticks:
            prof.close()
        log.append(run.tick(t))
        if ckpt and (t + 1) % args.ckpt_every == 0:
            ckpt.save(t + 1, run.checkpoint_tree(t + 1))
    prof.close()
    if ckpt:
        ckpt.wait()
    if run.telemetry is not None:
        run.telemetry.close()
    return log


if __name__ == "__main__":
    main()
