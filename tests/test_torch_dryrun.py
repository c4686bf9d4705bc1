"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* Its five pure cost functions (``cost_depths``, ``model_flops``,
  ``inner_scan_correction``, ``_extrapolate``, ``analytic_hbm_bytes``)
  equal JAX's bit for bit for every counted cell on both production meshes,
  under the config the port's ``build_cell`` makes. JAX's values come from
  ONE subprocess: importing ``repro.launch.dryrun`` sets XLA_FLAGS to 512
  host devices, which would change the device count of every later JAX test
  in this worker.
* The meta count equals the count of the same step run on real CPU tensors
  at smoke size, for a train, a prefill and a decode step of one config per
  family, op by op. Mamba2's SSD takes the card's route on both (B5's
  registered op, with its autograd Function); the model's own CPU route
  (the plain chunked form, differentiated by autograd) counts the same
  except in training, where without ``cfg.remat`` the card's route
  recomputes the forward in the backward: exactly the op's own row more.
  With ``cfg.remat`` (the default) the op's row counts each layer's
  recomputes too, and the CPU route recomputes its plain forward as often.
* B4's and B5's registered FLOP counts equal their formulas and the plain
  versions' counts, on the CPU and on meta; B4's masked count is the pairs
  its mask keeps.
* The tracker's live bytes, and the CLI: ``--list`` and full-size cells
  written with JAX's field names.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import config as tc
from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.ssd_scan import ops as ss_ops, ref as ss_ref
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import ssm as tssm

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")
CELLS = [(a, s) for a, s, skip in tc.cells(include_skipped=True) if not skip]

JAX_SCRIPT = r"""
import json, sys
from repro import config as C, sharding as SH
from repro.launch import dryrun as D   # sets XLA_FLAGS: this process only
req = json.load(sys.stdin)
out = []
for r in req:
    cfg = C.ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in r["cfg"].items()})
    shape = C.ShapeConfig(**r["shape"])
    mi = SH.MeshInfo(axis_names=tuple(r["axes"]), axis_sizes=dict(zip(r["axes"], r["sizes"])))
    mb = r["mb"]
    o1, o2, u_full, u1, u2 = D.cost_depths(cfg)
    c1, c2 = r["c1"], r["c2"]
    out.append({"cost_depths": [o1, o2, u_full, u1, u2],
                "model_flops": D.model_flops(cfg, shape, mb),
                "inner_scan_correction": D.inner_scan_correction(cfg, shape, mb),
                "analytic_hbm_bytes": D.analytic_hbm_bytes(cfg, shape, mb, mi),
                "extrapolate": D._extrapolate(c1, c2, u1, u2, u_full)})
print(json.dumps(out))
"""


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests():
    """Every counted cell on both meshes, each under the config the port's
    build_cell makes and the shape before the microbatch fold."""
    reqs = []
    for arch, shape in CELLS:
        for m in MESHES:
            mesh = tmesh.make_production_mesh(multi_pod=m == "multi")
            cfg, _, mb = dryrun.cell_config(arch, shape, mesh, overrides=dryrun.BASE_OVERRIDES)
            full = tc.SHAPES[shape]
            mf = dryrun.model_flops(cfg, full, mb)
            # extrapolation inputs with collectives, as JAX's records carry
            c1 = {"flops": mf / 7.0 + 3.0, "bytes": mf / 11.0, "coll": {"total": mf / 13.0}}
            c2 = {"flops": mf / 5.0 + 1.0, "bytes": mf / 3.0,
                  "coll": {"total": mf / 9.0, "dcn": 17.0}}
            reqs.append({"cell": [arch, shape, m], "cfg": dataclasses.asdict(cfg),
                         "shape": dataclasses.asdict(full), "mb": mb,
                         "axes": list(mesh.axis_names), "sizes": list(mesh.shape),
                         "c1": c1, "c2": c2, "_cfg": cfg, "_mesh": mesh})
    return reqs


@pytest.fixture(scope="module")
def jax_values():
    reqs = _requests()
    payload = json.dumps([{k: v for k, v in r.items() if not k.startswith("_")}
                          for r in reqs])
    out = subprocess.run([sys.executable, "-c", JAX_SCRIPT], input=payload, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**{k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
                              "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-4000:]
    return reqs, json.loads(out.stdout)


def test_cost_functions_equal_jax_bit_for_bit(jax_values):
    reqs, want = jax_values
    assert len(want) == 2 * 33
    for r, w in zip(reqs, want):
        cfg, mesh = r["_cfg"], r["_mesh"]
        full = tc.SHAPES[r["cell"][1]]
        mi = dryrun.SH.mesh_info(mesh)
        o1, o2, u_full, u1, u2 = dryrun.cost_depths(cfg)
        got = {"cost_depths": [o1, o2, u_full, u1, u2],
               "model_flops": dryrun.model_flops(cfg, full, r["mb"]),
               "inner_scan_correction": dryrun.inner_scan_correction(cfg, full, r["mb"]),
               "analytic_hbm_bytes": dryrun.analytic_hbm_bytes(cfg, full, r["mb"], mi),
               "extrapolate": dryrun._extrapolate(r["c1"], r["c2"], u1, u2, u_full)}
        # a JSON round trip of a float is exact: == is bit for bit
        assert json.loads(json.dumps(got)) == w, r["cell"]


def test_cell_configs_apply_jax_overrides():
    single, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    cfg, shape, mb = dryrun.cell_config("stablelm_12b", "decode_32k", single,
                                        overrides=dryrun.BASE_OVERRIDES)
    # 32 q heads, 8 kv heads over tp 16: q sharded, kv replicated 2x for the caches
    assert (cfg.kv_replication, cfg.attn_chunk, mb) == (2, 2048, 1)
    cfg, shape, mb = dryrun.cell_config("mixtral_8x22b", "train_4k", multi,
                                        overrides=dryrun.BASE_OVERRIDES)
    # no microbatch fold: the step runs all 8 microbatches of the whole batch
    assert (cfg.moe_groups, mb, shape.global_batch) == (32, 8, 256)
    cfg, shape, mb = dryrun.cell_config("mixtral_8x22b", "train_4k", single,
                                        overrides=dryrun.BASE_OVERRIDES)
    assert (cfg.moe_groups, mb, shape.global_batch) == (16, 8, 256)
    assert cfg.scan_layers == tc.get_config("mixtral_8x22b").scan_layers


# ---------------------------------------------------------------------------
# meta == CPU at smoke size
# ---------------------------------------------------------------------------
FAMILIES = {"dense": "stablelm_12b", "moe": "granite_moe_3b", "ssm": "mamba2_370m",
            "hybrid": "zamba2_2p7b", "vlm": "qwen2_vl_2b", "audio": "whisper_large_v3"}
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


def _card_route(cfg, x, dt, A, Bm, Cm, init_state=None):
    """``ssm.ssd_chunked`` as the card takes it, on any device: B5's
    wrapper (the registered op; under grad its autograd Function)."""
    return ss_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=min(cfg.ssm_chunk, x.shape[1]),
                           init_state=init_state)


def _smoke_count(family, kind, device, impl="xla", remat=True):
    arch = FAMILIES[family]
    cfg = dataclasses.replace(tc.get_smoke_config(arch), dtype="float32",
                              attention_impl=impl, remat=remat)
    # the chunked attention at 16 tokens (whisper's 12 frames too); the vlm's
    # 256 patches + 8 tokens through the dense path
    seq = 264 if family == "vlm" else 16
    over = {"attn_chunk": {"vlm": 0, "audio": 4}.get(family, 8)}
    if kind == "train":
        over["microbatches"] = 2
    *_, step, args, _ = dryrun.build_cell(arch, KINDS[kind], tmesh.make_host_mesh(),
                                          overrides=over, device=device, cfg=cfg,
                                          global_batch=2, seq_len=seq)
    return dryrun.count_step(step, args)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_meta_count_equals_cpu_count(family, kind, monkeypatch):
    monkeypatch.setattr(tssm, "ssd_chunked", _card_route)
    cpu, meta = _smoke_count(family, kind, "cpu"), _smoke_count(family, kind, "meta")
    assert cpu["flops"] > 0 and meta["flops"] == cpu["flops"]
    assert meta["flops_by_op"] == cpu["flops_by_op"]


@pytest.mark.parametrize("family", ["dense", "vlm", "audio"])
def test_meta_count_equals_cpu_count_through_b4(family):
    cpu = _smoke_count(family, "prefill", "cpu", impl="pallas")
    meta = _smoke_count(family, "prefill", "meta", impl="pallas")
    assert "repro_torch.flash_attention" in meta["flops_by_op"]
    assert meta["flops_by_op"] == cpu["flops_by_op"]
    assert meta["flops_masked"] == cpu["flops_masked"] < meta["flops"]
    xla = _smoke_count(family, "prefill", "meta")
    assert xla["flops"] == meta["flops"]       # B4's count is the plain one's


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_model_cpu_route_differs_only_by_the_recompute(family, kind):
    """The Mamba2 model's own CPU route (the plain chunked form, no op): the
    same count as meta's in prefill and decode; in training without remat
    meta counts exactly its op's row more (the forward that B5's backward
    recomputes). Under ``cfg.remat`` each layer's op runs r times (the
    forward and its recomputes: r = 2 for ssm, 3 for the hybrid's nested
    checkpoints), and so does the CPU route's plain forward, whose count is
    the op's: meta still counts exactly one forward more in all."""
    cpu = _smoke_count(family, kind, "cpu", remat=False)
    meta = _smoke_count(family, kind, "meta", remat=False)
    extra = dict(meta["flops_by_op"])
    op = extra.pop("repro_torch.ssd_scan", 0)
    assert (op > 0) == (kind != "decode")
    if kind != "train":
        assert meta["flops"] == cpu["flops"]
        return
    assert extra == cpu["flops_by_op"]
    r = {"ssm": 2, "hybrid": 3}[family]
    cpu_r, meta_r = _smoke_count(family, kind, "cpu"), _smoke_count(family, kind, "meta")
    assert meta_r["flops_by_op"]["repro_torch.ssd_scan"] == r * op
    assert meta_r["flops"] - cpu_r["flops"] == op


# ---------------------------------------------------------------------------
# the registered ops' counts
# ---------------------------------------------------------------------------
def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops(), fc.get_flop_counts()["Global"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("B,S,T,H,KV,hd", [(2, 16, 16, 4, 2, 8), (1, 24, 24, 6, 1, 16)])
def test_b4_registered_count_is_its_formula(device, B, S, T, H, KV, hd):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, H, hd, generator=g).to(device)
    k = torch.randn(B, T, KV, hd, generator=g).to(device)
    total, by_op = _count(lambda: fa_ops.flash_attention(q, k, k, window=5))
    assert total == 4 * B * H * S * T * hd == fa_ops.flops(q.shape, k.shape)
    assert list(map(str, by_op)) == ["repro_torch.flash_attention"]
    plain, _ = _count(lambda: fa_ref.attention_ref(q, k, k))
    assert plain == total


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("S,T,causal,window", [(16, 16, True, 0), (16, 16, True, 5),
                                               (12, 20, False, 7), (24, 24, False, 0)])
def test_b4_masked_count_keeps_the_mask_pairs(device, S, T, causal, window):
    """``flops_masked`` is 4 B H hd x the pairs the plain version's mask
    keeps, and a counted run's ``flops_masked`` takes B4's row down to it."""
    B, H, KV, hd = 2, 4, 2, 8
    g = torch.Generator().manual_seed(4)
    q = torch.randn(B, S, H, hd, generator=g).to(device)
    k = torch.randn(B, T, KV, hd, generator=g).to(device)
    qpos, kpos = torch.arange(S)[:, None], torch.arange(T)[None, :]
    keep = torch.ones(S, T, dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    want = 4 * B * H * hd * int(keep.sum())
    assert fa_ops.flops_masked(q.shape, k.shape, causal, window) == want
    c = dryrun.count_step(lambda: fa_ops.flash_attention(q, k, k, causal=causal,
                                                         window=window), ())
    assert c["flops"] == fa_ops.flops(q.shape, k.shape)
    assert c["flops_masked"] == want <= c["flops"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("B,S,H,G,N,P,Q", [(1, 32, 4, 1, 8, 8, 8), (2, 48, 4, 2, 16, 8, 16),
                                           (1, 8, 2, 1, 8, 8, 8)])
def test_b5_registered_count_is_its_formula(device, B, S, H, G, N, P, Q):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.rand(B, S, H, generator=g)
    a = -torch.rand(H, generator=g)
    Bm, Cm = torch.randn(B, S, G, N, generator=g), torch.randn(B, S, G, N, generator=g)
    ins = [t.to(device) for t in (x, dt, a, Bm, Cm)]
    total, by_op = _count(lambda: ss_ops.ssd_scan(*ins, chunk=Q))
    body = B * (2 * Q * Q * G * N + 2 * Q * Q * H * P + 4 * Q * H * N * P)
    assert total == (S // Q) * body
    assert list(map(str, by_op)) == ["repro_torch.ssd_scan"]
    plain, _ = _count(lambda: ss_ref.ssd_chunked_ref(*ins, chunk=Q))
    assert plain == total


def test_cpu_grad_through_b5_takes_the_function_and_its_backward():
    """A CPU call that needs gradients goes through the autograd Function,
    whose backward is the plain chunked form's gradient, as on the card."""
    g = torch.Generator().manual_seed(2)
    ins = [torch.randn(1, 16, 2, 8, generator=g), torch.rand(1, 16, 2, generator=g),
           -torch.rand(2, generator=g), torch.randn(1, 16, 1, 8, generator=g),
           torch.randn(1, 16, 1, 8, generator=g)]
    live = [t.clone().requires_grad_(True) for t in ins]
    kernels.reset_launches()
    y, _ = ss_ops.ssd_scan(*live, chunk=8)
    assert torch.equal(y, ss_ref.ssd_scan_ref(*ins, chunk=8)[0])
    gy = torch.randn(y.shape, generator=g)
    got = torch.autograd.grad(y, live, gy)
    want = ss_ops.ssd_scan_backward(*ins, None, 8, gy, None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ss_ops.ssd_scan.launches == 0      # a CPU call launches nothing


def test_cpu_grad_through_b4_takes_the_plain_version():
    """The op has no backward: a CPU call that needs gradients runs the
    plain version itself, with its autograd gradient."""
    g = torch.Generator().manual_seed(3)
    q, k = torch.randn(1, 8, 2, 8, generator=g), torch.randn(1, 8, 1, 8, generator=g)
    live = [t.clone().requires_grad_(True) for t in (q, k, k)]
    out = fa_ops.flash_attention(*live)
    want = fa_ref.attention_ref(q, k, k)
    assert torch.equal(out, want)
    gw = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, live, gw)
    ref_live = [t.clone().requires_grad_(True) for t in (q, k, k)]
    ref_grads = torch.autograd.grad(fa_ref.attention_ref(*ref_live), ref_live, gw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref_grads))


def test_host_check_extrapolates_exactly_and_doubles_the_batch():
    """The meta side of phase 19 at smoke size: the two depths extrapolate
    to the full depth's count exactly, peak_est is resident + peak, and the
    doubled run doubles the batch."""
    cfg = dataclasses.replace(tc.get_smoke_config("stablelm_12b"), num_layers=7)
    r = dryrun.host_check("stablelm_12b", "prefill_32k", global_batch=2, doubled=True,
                          cfg=cfg, seq_len=16, overrides={"attention_impl": "pallas"})
    assert (r["u1"], r["u2"], r["u_full"]) == (2, 6, 7)
    assert [r[k]["num_layers"] for k in ("l1", "l2", "full")] == [2, 6, 7]
    ext = dryrun._extrapolate({"flops": r["l1"]["flops"], "bytes": 0.0, "coll": {}},
                              {"flops": r["l2"]["flops"], "bytes": 0.0, "coll": {}},
                              2, 6, 7)["flops"]
    assert ext == r["full"]["flops"]
    for k in ("l1", "l2", "full", "l2_doubled"):
        assert r[k]["peak_est_bytes"] == r[k]["resident"] + r[k]["peak"]
    assert (r["l2"]["global_batch"], r["l2_doubled"]["global_batch"]) == (2, 4)
    assert r["l2_doubled"]["flops"] == 2 * r["l2"]["flops"]
    assert "repro_torch.flash_attention" in r["l1"]["flops_by_op"]
    assert r["l1"]["flops_masked"] < r["l1"]["flops"]
    json.dumps(r)


# ---------------------------------------------------------------------------
# the tracker and the CLI
# ---------------------------------------------------------------------------
def test_traffic_tracks_live_bytes_views_and_residents():
    from repro_torch.models.attention import KVCache

    cache = KVCache(k=torch.zeros(4, 256, device="meta"), v=torch.zeros(4, 256,
                                                                        device="meta"),
                    length=3)
    tr = dryrun.Traffic()
    tr.resident([cache])
    with tr:
        a = torch.ones(1024, device="meta")           # 4096 bytes
        b = a * 2                                     # +4096
        del a                                         # -4096
        c = b.view(32, 32)                            # a view: no bytes, no copy
        cache.k[:, 0] = 1.0                           # in place on a resident
        d = torch.ones(100, device="meta")            # 400 -> 512 bytes
    assert (tr.peak, tr.live) == (8192, 4096 + 512)
    # ones: 4096 written; mul: 4096 read, 4096 written; the scalar 1.0: 4;
    # its copy into the 4 rows of column 0: 16 + 4 read, 16 written; ones: 400
    assert tr.moved == 4096 + 8192 + 4 + 36 + 400
    del b, c, d


def test_cli_lists_the_grid(capsys):
    dryrun.main(["--list"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 40
    assert sum("SKIP: full attention" in line for line in lines) == 7


JAX_FIELDS = {"arch", "shape", "mesh", "tag", "chips", "microbatches", "params",
              "active_params", "cost_extrapolation", "flops_per_device_raw",
              "flops_per_device", "inner_scan_correction_total", "hbm_bytes_per_device",
              "collectives", "model_flops_total", "memory", "roofline_valid", "roofline"}


def test_cli_writes_full_size_cells_with_jax_fields(tmp_path, capsys):
    dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k", "--mesh", "both",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "stablelm_12b", "--shape", "long_500k", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "SKIPPED: full attention" in out and out.count("fits=") == 2
    skip = json.loads((tmp_path / "stablelm_12b__long_500k__skip.json").read_text())
    assert set(skip) == {"arch", "shape", "skipped"}
    for m, chips in (("single", 256), ("multi", 512)):
        rec = json.loads((tmp_path / f"mamba2_370m__decode_32k__{m}.json").read_text())
        assert JAX_FIELDS <= set(rec)
        assert {"hbm_bytes_counted", "count_s"} <= set(rec)
        assert (rec["mesh"], rec["chips"], rec["collectives"]) == (m, chips, None)
        assert rec["flops_per_device"] * chips == pytest.approx(rec["flops_total"], rel=1e-12)
        assert {"argument_bytes", "temp_bytes", "peak_est_bytes", "fits"} <= set(rec["memory"])
        r = rec["roofline"]
        assert {"t_compute", "t_memory", "t_collective", "t_dcn", "useful_flops_ratio",
                "dominant"} <= set(r)
        assert r["t_collective"] is None and r["dominant"] in ("t_compute", "t_memory")
        assert r["t_compute"] == rec["flops_per_device"] / 989e12
        # no B4 call: the masked count is the count
        assert rec["flops_total_masked"] == rec["flops_total"]
        assert r["t_compute_masked"] == r["t_compute"]
        assert rec["model_flops_total"] == 2.0 * rec["active_params"] * 128
        # a decode step: 48 layers, each SSM cache read once a token
        assert rec["cost_extrapolation"] == {"u1": 2, "u2": 6, "u_full": 48}
