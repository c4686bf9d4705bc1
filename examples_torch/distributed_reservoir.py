"""D-R-TBS over 8 reservoir shards (paper Sec. 5.3, Fig. 6(b)) driving the
paper's full model-management loop on the PyTorch/CUDA port: stream ->
per-shard sample update -> periodic retrain on the realized global sample
-> prequential eval, through ``repro_torch.manage.make_sharded_run_loop``.

Run as one process, the shards are a leading dimension of one card's state
(``repro_torch.launch.mesh.make_data_mesh``): no second process, no device
flags. Run under ``torch.distributed.run``, each rank holds one shard
(``--shards`` must equal the number of ranks) and its state is that row of
the one-process run's.

Run on the card: ``PYTHONPATH=src python examples_torch/distributed_reservoir.py``
(``--device cpu`` runs the plain CPU versions; ``--ticks`` sets the
stream's length, 24 by default). Over ranks: ``PYTHONPATH=src python -m
torch.distributed.run --standalone --nproc-per-node 8
examples_torch/distributed_reservoir.py`` (gloo where the ranks outnumber
the cards, which NCCL refuses, or with ``--device cpu``; NCCL with a card a
rank).
"""
import argparse

from repro_torch.core import prng
from repro_torch.core.api import make_sampler
from repro_torch.data.streams import LinRegStream, mode_schedule
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.manage import (make_model, make_sharded_run_loop, materialize_stream,
                                shard_stream)

S, B, N, LAM = 8, 64, 100, 0.1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--ticks", type=int, default=24)
    ap.add_argument("--shards", type=int, default=S)
    args = ap.parse_args(argv)
    T, shards = args.ticks, args.shards
    device, group = args.device, None
    if ranks.launched():             # one shard a rank
        import torch.distributed as dist

        device = ranks.init(device=args.device)
        group = dist.group.WORLD
    mesh = make_data_mesh(shards, device=device, group=group)
    dev = mesh.device
    lead = mesh.rank == 0

    # one global stream, co-partitioned: shard s owns slots [s bcap_s, (s + 1) bcap_s)
    batches, bcounts = materialize_stream(LinRegStream(seed=0), T, batch_size=B,
                                          mode=lambda t: mode_schedule("single", t),
                                          device=dev)
    batches, bcounts = shard_stream(batches, bcounts, shards, device=dev,
                                    rank=None if group is None else mesh.rank)
    sampler = make_sampler("drtbs", n=N, lam=LAM, cap_s=N + B, device=dev)
    model = make_model("linreg", dim=2, device=dev)
    run = make_sharded_run_loop(sampler, model, mesh, retrain_every=2)

    form = "on one device" if group is None else "one a rank"
    if lead:
        print(f"mesh: {shards} shards {form}, {dev}; global reservoir n={N}; {T} ticks")
    state, params, trace = run(prng.key(0), batches, bcounts)

    metric = trace["metric"].cpu().numpy()
    size = trace["size"].cpu().numpy()
    if lead:
        for t in range(T):
            print(f"  t={t:2d} mse={metric[t]:7.3f}  |S|={int(size[t]):3d}")
    print(f"{'final' if group is None else f'rank {mesh.rank}:'} shard fulls="
          f"{state.nfull.tolist()}  C={float(state.weight[0]):.2f}  "
          f"W={float(state.total_weight[0]):.2f}")
    if int(state.overflow.sum()) != 0 or not (size <= N).all():
        raise RuntimeError("the sharded reservoir overflowed or grew past n")
    if lead:
        print("bounded and co-partitioned -- done.")
    return state, params, trace


if __name__ == "__main__":
    main()
