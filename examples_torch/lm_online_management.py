"""Keep a language model fresh on a drifting token stream by periodically
retraining it on the R-TBS sample (the paper's loop, lifted to the LM zoo),
on the PyTorch/CUDA port.

Uses the reduced stablelm-family config (``--preset smoke``); pass
``--preset full --arch <id>`` for a full-size model. The run prints the
prequential eval loss around two drift events: watch it spike at the mode
flips and recover after the next retraining. ``--scheme sw`` or ``--scheme
brs`` swaps the sampler.

Run on the card: ``PYTHONPATH=src python examples_torch/lm_online_management.py``
(``--device cpu`` runs the plain CPU versions). Any other flag of
``python -m repro_torch.launch.train`` overrides this example's own (the
last one given wins).
"""
import argparse

from repro_torch.launch.train import main as train_main

ARGS = ["--arch", "stablelm_12b", "--scheme", "rtbs", "--preset", "smoke",
        "--ticks", "24", "--batch-per-tick", "24", "--reservoir", "128",
        "--lam", "0.15", "--seq-len", "48", "--retrain-every", "3",
        "--retrain-steps", "8", "--train-batch", "12", "--drift", "periodic"]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args, rest = ap.parse_known_args(argv)
    log = train_main(ARGS + rest, device=args.device)
    k = min(3, len(log))
    pre = [r["eval_loss"] for r in log[:k]]
    post = [r["eval_loss"] for r in log[-k:]]
    print(f"\nmean eval loss: first {k} ticks {sum(pre) / k:.3f} -> "
          f"last {k} ticks {sum(post) / k:.3f}")
    return log


if __name__ == "__main__":
    main()
