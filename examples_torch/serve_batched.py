"""Batched serving on the PyTorch/CUDA port: prefill a batch of prompts
through the Mamba2 (attention-free) model and decode greedily, O(1) state
per sequence.

Run on the card: ``PYTHONPATH=src python examples_torch/serve_batched.py``
(``--device cpu`` runs the plain CPU versions). Any other flag of
``python -m repro_torch.launch.serve`` overrides this example's own (the
last one given wins).
"""
import argparse

from repro_torch.launch.serve import main as serve_main

ARGS = ["--arch", "mamba2_370m", "--preset", "smoke", "--prompts", "4",
        "--prompt-len", "16", "--gen", "12"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args, rest = ap.parse_known_args(argv)
    return serve_main(ARGS + rest, device=args.device)


if __name__ == "__main__":
    main()
