"""Batched serving driver: prefill a batch of prompts, decode greedily.

The port of the JAX package's ``launch/serve.py``: the same flags and the
same printed lines. It runs on the CUDA card unless ``device="cpu"`` is
passed to :func:`main`. :func:`serve_batch` is the prefill + decode body,
which ``main`` and ``chip_smoke.py`` both call. It serves every arch of
``repro_torch.config.ARCH_IDS``: the dense and MoE transformers (KV caches,
kernel B4 under ``attention_impl="pallas"``), qwen2-vl (stubbed patch
embeddings prepended to the prompt), the default ``mamba2_370m`` (per-layer
SSM state; kernel B5 in every prefill), zamba2 (B5 a Mamba2 layer, B4 an
invocation of the shared block) and whisper (stubbed audio frames; the
encoder runs inside the prefill).

With ``--telemetry-dir`` / ``--telemetry-stdout`` (or a
:class:`repro_torch.obs.Telemetry` handle passed as ``telemetry=``) the
driver emits one ``kind="query"`` record per served prompt -- prompt and
generated lengths, prefill and decode wall time, cumulative tokens served
-- after a ``kind="run"`` header with ``mode="serve"``, through the same
sinks the manage loops drain into, as the JAX package's serve does.

Examples (on the card):
  PYTHONPATH=src python -m repro_torch.launch.serve --preset full \\
      --prompts 4 --prompt-len 4096 --gen 32          # mamba2_370m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_12b \\
      --preset smoke --prompts 4 --prompt-len 16 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_moe_3b \\
      --preset full --prompts 8 --prompt-len 2048 --gen 32
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import _device
from repro_torch import config as C
from repro_torch.kernels import launches
from repro_torch.models import zoo
from repro_torch.obs import make_telemetry
from repro_torch.obs.profile import scope
from repro_torch.train.steps import make_decode_step


@dataclasses.dataclass
class Served:
    tokens: np.ndarray          # [prompts, 1 + gen]: the prefill's token, then gen more
    prefill_s: float            # wall time of the prefill and its first token
    decode_s: float             # wall time of the gen decode steps
    prefill_launches: dict      # kernel launches during the prefill, by wrapper
    decode_launches: dict       # ... and during the decode steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


@torch.no_grad()
def serve_batch(api, params, batch: dict, gen: int) -> Served:
    """Prefill ``batch`` (``{"tokens": [prompts, n]}``, plus
    ``frontend_embeds`` for vlm and audio) into caches of ``prompt_len + gen
    + 1`` slots (a KV cache's length; SSM state ignores it), where
    ``prompt_len`` is n plus a vlm batch's patches, take the greedy token,
    then decode ``gen`` more greedily. Waits for the device at the end of
    each phase, so the times are wall times of finished work."""
    tokens = batch["tokens"]
    dev = tokens.device
    prompt_len = tokens.shape[1]
    if api.cfg.family == "vlm" and batch.get("frontend_embeds") is not None:
        prompt_len += batch["frontend_embeds"].shape[1]
    max_len = prompt_len + gen + 1
    n0 = launches()
    t0 = time.perf_counter()
    with scope("serve.prefill"):
        logits, caches = api.prefill(params, batch, max_len)
        tok = torch.argmax(logits[:, :, : api.cfg.vocab_size], dim=-1)
        _sync(dev)
    prefill_s = time.perf_counter() - t0
    n1 = launches()

    decode = make_decode_step(api)
    outs = [tok]
    t0 = time.perf_counter()
    with scope("serve.decode"):
        for _ in range(gen):
            tok, caches = decode(params, caches, tok)
            outs.append(tok)
        out = torch.cat(outs, dim=1).cpu().numpy()
    decode_s = time.perf_counter() - t0
    return Served(tokens=out, prefill_s=prefill_s, decode_s=decode_s,
                  prefill_launches=_delta(n1, n0), decode_launches=_delta(launches(), n1))


def main(argv=None, telemetry=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_370m")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry-dir", default=None,
                    help="write per-query serving telemetry (JSONL) under "
                         "this directory (repro_torch.obs)")
    ap.add_argument("--telemetry-stdout", action="store_true",
                    help="echo telemetry records to stdout")
    args = ap.parse_args(argv)
    dev = _device.resolve(device)
    own_telemetry = False
    if telemetry is None and (args.telemetry_dir or args.telemetry_stdout):
        telemetry = make_telemetry(args.telemetry_dir, stdout=args.telemetry_stdout,
                                   monitors=())
        own_telemetry = True

    cfg = (C.get_smoke_config(args.arch) if args.preset == "smoke"
           else C.get_config(args.arch))
    api = zoo.build(cfg)
    params = api.init_params(args.seed, device=dev)
    if telemetry is not None:
        telemetry.open_run({"mode": "serve", "arch": args.arch, "prompts": args.prompts,
                            "prompt_len": args.prompt_len, "gen": args.gen,
                            "backend": dev.type, "jax": None, "torch": torch.__version__})
    batch = zoo.make_demo_batch(cfg, torch.Generator(device=dev).manual_seed(args.seed + 1),
                                args.prompts, args.prompt_len)
    res = serve_batch(api, params, batch, args.gen)
    print(f"[serve] prefill: {res.prefill_s:.2f}s")
    print(f"[serve] decoded {args.gen} tokens x {args.prompts} seqs "
          f"in {res.decode_s:.2f}s ({args.gen * args.prompts / res.decode_s:.1f} tok/s)")
    print("[serve] first sequence:", res.tokens[0].tolist())
    if telemetry is not None:
        served = 0
        for q in range(args.prompts):
            served += int(res.tokens.shape[1])
            telemetry.emit({
                "kind": "query", "query": q,
                "prompt_len": args.prompt_len,
                "gen_tokens": int(res.tokens.shape[1]),
                "tokens_served": served,  # cumulative across the batch
                "prefill_s": res.prefill_s / args.prompts,
                "decode_s": res.decode_s / args.prompts,
                "tok_per_s": args.gen * args.prompts / max(res.decode_s, 1e-9),
            })
        telemetry.flush()
        if own_telemetry:
            telemetry.close()
    return res.tokens


if __name__ == "__main__":
    main()
