"""Quickstart on the PyTorch/CUDA port: temporally-biased sampling and online
model management through ``repro_torch``'s sampler API.

1. ``make_sampler``: R-TBS, B-RS, SW and T-TBS behind one ``init / step /
   extract`` interface; swap schemes by changing a string.
2. R-TBS inclusion probabilities decay at exactly e^{-lambda * age}: every
   trial runs at once, the trials a leading dimension of the sampler's
   state (a key tensor whose row i is trial i's key).
3. ``repro_torch.manage``: the paper's stream -> sample -> retrain -> eval
   loop, for two schemes x two models.

Run on the card: ``PYTHONPATH=src python examples_torch/quickstart.py``
(``--device cpu`` runs the plain CPU versions; ``--trials N`` sets part 2's
trials, 3,000 by default).
"""
import argparse

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import prng
from repro_torch.core.api import make_sampler
from repro_torch.data.streams import LinRegStream, UsenetLikeStream, mode_schedule
from repro_torch.manage import make_model, make_run_loop, materialize_stream


def _stacked(tree, n):
    return torch.utils._pytree.tree_map(
        lambda a: a.unsqueeze(0).expand((n,) + tuple(a.shape)).clone(), tree)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--trials", type=int, default=3000)
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    proto = torch.zeros((), dtype=torch.int32, device=dev)
    out = {"device": str(dev)}

    print("== 1. one interface, every scheme ==")
    batch_sizes = [5, 80, 0, 0, 33, 7, 120, 1, 0, 64]
    out["sizes"] = {}
    for scheme, kw in [("rtbs", dict(n=50, lam=0.2)),
                       ("brs", dict(n=50)),
                       ("sw", dict(n=50)),
                       ("ttbs", dict(n=50, lam=0.2, batch_size=35))]:
        sampler = make_sampler(scheme, device=dev, **kw)
        state = sampler.init(proto)
        for t, b in enumerate(batch_sizes):
            items = torch.arange(128, dtype=torch.int32, device=dev) + 1000 * (t + 1)
            state = sampler.step(prng.fold_in(prng.key(0), t), state, items,
                                 torch.tensor(b, device=dev))
        view = sampler.extract(prng.key(99), state)
        out["sizes"][scheme] = int(view.size)
        print(f"  {scheme:5s} after {sum(batch_sizes)} items: |S| = {int(view.size)}")

    print("\n== 2. empirical inclusion probabilities obey eq. (1) ==")
    T, trials, n, lam = 6, args.trials, 10, 0.35
    sampler = make_sampler("rtbs", n=n, lam=lam, device=dev)
    keys = prng.key_rows(prng.key(0), trials, dev)        # trial i: split(key, trials)[i]
    st = _stacked(sampler.init(proto), trials)
    for t in range(T):
        items = torch.arange(8, dtype=torch.int32, device=dev) + 1000 * (t + 1)
        st = sampler.step(prng.fold_in(keys, t), st, items, torch.tensor(5, device=dev))
    view = sampler.extract(prng.fold_in(keys, 99), st)
    ages = T - view.items.cpu().numpy() // 1000            # age 0 = newest batch
    mask = view.mask.cpu().numpy()
    probs = np.array([((ages == a) & mask).sum() / 5 / trials for a in range(T)])
    out["probs"] = probs.tolist()
    print("  age  Pr[in sample]  Pr[age]/Pr[age-1]  (target e^-lambda = %.3f)" % np.exp(-lam))
    for a in range(T):
        r = probs[a] / max(probs[a - 1], 1e-9) if a else float("nan")
        print(f"  {a:3d}  {probs[a]:.3f}          {r:5.3f}")

    print("\n== 3. online model management: one loop, any scheme x model ==")
    T = 40
    lin = materialize_stream(LinRegStream(seed=0), T, batch_size=100,
                             mode=lambda t: mode_schedule("single", t, start=20, stop=30),
                             device=dev)
    use = UsenetLikeStream(seed=0)
    nb = materialize_stream(use, T, batch_size=50, device=dev)
    runs = [("rtbs", dict(n=300, lam=0.1), "linreg", dict(dim=2), lin, "mse"),
            ("sw", dict(n=300), "linreg", dict(dim=2), lin, "mse"),
            ("rtbs", dict(n=300, lam=0.3), "naive_bayes", dict(vocab=use.vocab), nb, "miss"),
            ("brs", dict(n=300), "naive_bayes", dict(vocab=use.vocab), nb, "miss")]
    out["runs"] = []
    for scheme, skw, model_name, mkw, (batches, bcounts), unit in runs:
        run = make_run_loop(make_sampler(scheme, device=dev, **skw),
                            make_model(model_name, device=dev, **mkw))
        _, _, trace = run(prng.key(7), batches, bcounts)
        m = trace["metric"].cpu().numpy()
        mid = m[T // 2 - 3: T // 2 + 3].mean()             # around the drift window
        out["runs"].append((scheme, model_name, m))
        print(f"  {scheme:5s} + {model_name:11s} {unit}: start {m[1:6].mean():6.3f}"
              f"  drift {mid:6.3f}  end {m[-5:].mean():6.3f}"
              f"  (avg |S| {trace['size'].double().mean().item():.0f})")
    print("done: the paper's headline loop on", dev)
    return out


if __name__ == "__main__":
    main()
