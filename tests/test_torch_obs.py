"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs`` on the CPU:

  * twins of tests/test_obs.py's sink and monitor tests (the host side is a
    copy, so the same records give the same warnings);
  * the instrumented loops: ``make_run_loop`` (with and without a
    controller) and ``make_bank_run_loop`` with ``telemetry=`` give outputs
    bit-identical to ``telemetry=None``, drain every tick in order, with
    JAX's columns (checked against JAX's own instrumented run of the same
    configuration), the Thm 4.1 recursions hold on the drained columns, and
    the JSONL passes ``benchmarks/check_telemetry.py`` unchanged;
  * the drain itself: rows of mixed dtypes and [Q] columns come back exact,
    in blocks of ``every``;
  * the driver's and serve's telemetry flags.
"""
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.bank import make_bank as j_make_bank
from repro.core.api import make_sampler as j_make_sampler
from repro.data.streams import KeyedStream as JKeyedStream
from repro.data.streams import LinRegStream as JLinRegStream
from repro.manage import make_bank_run_loop as j_make_bank_run_loop
from repro.manage import make_model as j_make_model
from repro.manage import make_run_loop as j_make_run_loop
from repro.manage import materialize_stream as j_materialize_stream
from repro.obs import MemorySink as JMemorySink
from repro.obs import Telemetry as JTelemetry
from repro_torch.bank import make_bank
from repro_torch.core import prng
from repro_torch.core.api import make_sampler
from repro_torch.data.streams import KeyedStream, LinRegStream
from repro_torch.decay import loss_ratio
from repro_torch.manage import make_bank_run_loop, make_model, make_run_loop, materialize_stream
from repro_torch.obs import (InclusionDrift, JsonlSink, MemorySink, NanAlarm, OverflowAlarm,
                             SampleSizeStability, StdoutSink, StuckLambda, Telemetry,
                             default_monitors, make_telemetry, state_nbytes, tree_nbytes)

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _check_file():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry", ROOT / "benchmarks" / "check_telemetry.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.check_file


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# sinks and monitors (twins of tests/test_obs.py)
# ---------------------------------------------------------------------------
def test_jsonl_sink_roundtrip(tmp_path):
    path = tmp_path / "sub" / "telemetry.jsonl"
    s = JsonlSink(str(path))
    s.emit({"kind": "tick", "t": 0, "metric": torch.tensor(1.5), "size": np.int32(7),
            "vec": np.arange(3)})
    s.emit({"kind": "warning", "monitor": "nan", "message": "boom"})
    s.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert recs[0] == {"kind": "tick", "t": 0, "metric": 1.5, "size": 7, "vec": [0, 1, 2]}
    assert recs[1]["monitor"] == "nan"
    s2 = JsonlSink(str(path))
    s2.emit({"kind": "tick", "t": 1})
    s2.close()
    assert len(path.read_text().splitlines()) == 3


def test_memory_sink_ring_and_filter():
    s = MemorySink(capacity=3)
    for t in range(5):
        s.emit({"kind": "tick", "t": t})
    s.emit({"kind": "warning", "monitor": "m", "message": "x"})
    assert [r["t"] for r in s.by_kind("tick")] == [3, 4]
    assert len(s.by_kind("warning")) == 1


def test_stdout_sink_kind_filter(capsys):
    s = StdoutSink(kinds=("warning",))
    s.emit({"kind": "tick", "t": 0})
    s.emit({"kind": "warning", "monitor": "m", "message": "x"})
    s.flush()
    out = capsys.readouterr().out
    assert "warning" in out and "tick" not in out


def test_nan_alarm_fires_on_nonfinite_metric():
    m = NanAlarm()
    assert m.observe({"kind": "tick", "t": 0, "metric": 1.0, "bcount": 4}) == []
    ws = m.observe({"kind": "tick", "t": 1, "metric": float("nan"), "bcount": 4})
    assert ws and ws[0]["kind"] == "warning" and ws[0]["monitor"] == m.name


def test_overflow_alarm_fires_and_cools_down():
    m = OverflowAlarm(cooldown=2)
    ws = m.observe({"kind": "tick", "t": 0, "overflow": 3})
    assert len(ws) == 1 and "3" in str(ws[0])
    assert m.observe({"kind": "tick", "t": 1, "overflow": 5}) == []
    assert m.observe({"kind": "tick", "t": 2, "overflow": 5}) == []
    assert len(m.observe({"kind": "tick", "t": 3, "overflow": 1})) == 1


def test_stuck_lambda_fires_after_patience():
    m = StuckLambda(patience=3, lam_max=0.5)
    ws = []
    for t in range(8):
        ws += m.observe({"kind": "tick", "t": t, "lam": 0.5 if t else 0.1, "pulse": False})
    assert any(w["monitor"] == m.name for w in ws)


def test_inclusion_drift_detects_broken_recursion():
    m = InclusionDrift(rtol=0.05, warmup=2)
    w, ws = 0.0, []
    for t in range(10):
        w = 0.9 * w + 16.0
        ws += m.observe({"kind": "tick", "t": t, "decay": 0.9, "bcount": 16,
                         "total_weight": w})
    assert ws == []
    ws = m.observe({"kind": "tick", "t": 10, "decay": 0.9, "bcount": 16,
                    "total_weight": 2.0 * w})
    assert ws and ws[0]["monitor"] == m.name


def test_sample_size_stability_flags_collapse():
    m = SampleSizeStability(window=8, rtol=0.2, atol=1.0)
    ws = []
    for t in range(16):
        ws += m.observe({"kind": "tick", "t": t, "size": 50, "weight": 50.0})
    assert ws == []
    for t in range(16, 32):
        ws += m.observe({"kind": "tick", "t": t, "size": 5, "weight": 50.0})
    assert any(w["monitor"] == m.name for w in ws)


def test_tree_nbytes_and_every_validation():
    tree = {"a": torch.zeros((4, 2)), "b": torch.zeros((3,), dtype=torch.int32),
            "c": np.zeros((5,), np.int8)}
    assert tree_nbytes(tree) == 4 * 2 * 4 + 3 * 4 + 5
    proto = {"x": torch.zeros(2), "y": torch.zeros(())}
    for scheme, kw in (("rtbs", dict(n=50, lam=0.1)), ("brs", dict(n=10))):
        s = make_sampler(scheme, device=CPU, **kw)   # sized on the meta device
        assert state_nbytes(s.init, proto) == tree_nbytes(s.init(proto)) > 0
    with pytest.raises(ValueError):
        Telemetry([MemorySink()], every=0)
    with pytest.raises(ValueError, match="transport"):
        Telemetry([MemorySink()], transport="nope")


# ---------------------------------------------------------------------------
# the drain
# ---------------------------------------------------------------------------
def test_row_drain_returns_rows_exactly_in_blocks():
    mem = MemorySink()
    tel = Telemetry([mem], every=3)
    drain = tel.drain(CPU)
    rows = []
    for t in range(7):
        row = {"t": t, "flag": t % 2 == 0, "x": torch.tensor(1.0 / (t + 3)),
               "n": torch.tensor(2 ** 31 - 1 - t, dtype=torch.int64),
               "q": torch.arange(3, dtype=torch.int32) * t, "b": torch.tensor(t > 3)}
        rows.append(row)
        drain.push(row)
    assert tel.drains == 2 and len(mem.records) == 6          # two whole blocks so far
    drain.finish()
    assert tel.drains == 3
    got = mem.by_kind("tick")
    assert [r["t"] for r in got] == list(range(7))
    for r, want in zip(got, rows):
        assert r["flag"] is want["flag"] and r["b"] is bool(want["b"])
        assert r["x"] == float(want["x"]) and r["n"] == int(want["n"])
        assert r["q"] == want["q"].tolist()


# ---------------------------------------------------------------------------
# the instrumented loops
# ---------------------------------------------------------------------------
def _linreg(T=23, b=20):
    return materialize_stream(LinRegStream(seed=0), T, batch_size=b, device=CPU)


def _jax_tick_columns(run_on, T, every):
    mem = JMemorySink()
    tel = JTelemetry([mem], every=every, monitors=())
    run_on(tel)
    ticks = mem.by_kind("tick")
    assert len(ticks) == T
    return set(ticks[0]), mem.by_kind("run")[0]


def test_run_loop_telemetry_bit_identity_and_records(tmp_path):
    sampler = make_sampler("rtbs", n=50, lam=0.1, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    batches, bcounts = _linreg()
    mem = MemorySink()
    tel = Telemetry([mem, JsonlSink(str(tmp_path / "t.jsonl"))], every=6,
                    monitors=default_monitors())
    off = make_run_loop(sampler, model, retrain_every=4)(prng.key(7), batches, bcounts)
    run_on = make_run_loop(sampler, model, retrain_every=4, telemetry=tel)
    _equal(off, run_on(prng.key(7), batches, bcounts))
    runs, ticks = mem.by_kind("run"), mem.by_kind("tick")
    assert len(runs) == 1 and runs[0]["scheme"] == "rtbs" and runs[0]["ticks"] == 23
    assert runs[0]["jax"] is None and runs[0]["torch"] == torch.__version__
    assert runs[0]["state_bytes"] == tree_nbytes(sampler.init(
        {"x": torch.zeros(2), "y": torch.zeros(())}))
    assert [r["t"] for r in ticks] == list(range(23))
    assert tel.drains == 4                                   # 6 + 6 + 6 + 5
    assert ticks[0]["retrain"] is False and ticks[3]["retrain"] is True
    assert mem.by_kind("warning") == []
    # the drained rows are the trace's numbers
    assert [r["metric"] for r in ticks[1:]] == off[2]["metric"][1:].tolist()
    assert [r["size"] for r in ticks] == off[2]["size"].tolist()
    # Thm 4.1's recursion from the drained columns, in f32 with two roundings
    w = np.float32(0.0)
    for r in ticks:
        w = np.float32(np.float32(np.float32(r["decay"]) * w) + np.float32(r["bcount"]))
        assert float(w) == r["total_weight"]
    # JAX's instrumented loop on the same configuration has the same columns
    jb, jc = j_materialize_stream(JLinRegStream(seed=0), 23, batch_size=20)
    cols, jrun = _jax_tick_columns(
        lambda tel_: j_make_run_loop(j_make_sampler("rtbs", n=50, lam=0.1),
                                     j_make_model("linreg", dim=2), retrain_every=4,
                                     telemetry=tel_)(jax.random.key(7), jb, jc), 23, 6)
    assert set(ticks[0]) == cols
    assert set(runs[0]) == set(jrun) | {"torch"}
    assert _check_file()(tmp_path / "t.jsonl") == []
    run_on(prng.key(7), batches, bcounts)                    # a second run re-opens
    assert len(mem.by_kind("run")) == 2 and len(mem.by_kind("tick")) == 46


def test_run_loop_telemetry_controller_gauges():
    sampler = make_sampler("rtbs", n=40, lam=0.1, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    ctrl = loss_ratio(lam0=0.1, lam_min=0.02, lam_max=0.8)
    batches, bcounts = _linreg(T=12, b=16)
    mem = MemorySink()
    tel = Telemetry([mem], every=4, monitors=default_monitors(lam_max=0.8))
    off = make_run_loop(sampler, model, retrain_every=3, controller=ctrl)
    on = make_run_loop(sampler, model, retrain_every=3, controller=ctrl, telemetry=tel)
    out_off = off(prng.key(3), batches, bcounts)
    _equal(out_off, on(prng.key(3), batches, bcounts))
    ticks = mem.by_kind("tick")
    assert {"lam", "hold", "pulse", "decay"} <= set(ticks[0])
    assert [r["decay"] for r in ticks] == out_off[2]["decay"].tolist()
    assert isinstance(ticks[0]["pulse"], bool) and isinstance(ticks[0]["hold"], int)


@pytest.mark.parametrize("scheme", ["ttbs", "brs"])
def test_run_loop_telemetry_other_schemes(scheme):
    hyper = dict(n=30, lam=0.1, batch_size=16) if scheme == "ttbs" else dict(n=30)
    sampler = make_sampler(scheme, device=CPU, **hyper)
    model = make_model("linreg", dim=2, device=CPU)
    batches, bcounts = _linreg(T=10, b=16)
    assert isinstance(make_telemetry(None, every=4, monitors=()).sinks[0], MemorySink)
    mem = MemorySink()
    tel = Telemetry([mem], every=4)
    off = make_run_loop(sampler, model, retrain_every=2)(prng.key(1), batches, bcounts)
    _equal(off, make_run_loop(sampler, model, retrain_every=2, telemetry=tel)(
        prng.key(1), batches, bcounts))
    ticks = mem.by_kind("tick")
    assert [r["t"] for r in ticks] == list(range(10))
    assert "overflow_total" in ticks[0] and "weight" in ticks[0]
    assert ("decay" in ticks[0]) == (scheme == "ttbs")


def _keyed(K=16, T=14, b=24):
    return materialize_stream(KeyedStream(base=LinRegStream(seed=0), num_keys=K, seed=0), T,
                              batch_size=b, fields=("key", "x", "y"), device=CPU)


def test_bank_loop_telemetry_bit_identity_and_records(tmp_path):
    K, Q, T = 16, 4, 14
    batches, bcounts = _keyed(K=K, T=T)
    bank = make_bank("rtbs", num_keys=K, n=8, lam=0.1, bcap=2, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    off = make_bank_run_loop(bank, model, retrain_every=4, train_keys=range(Q))
    mem = MemorySink()
    tel = Telemetry([mem, JsonlSink(str(tmp_path / "b.jsonl"))], every=4,
                    monitors=default_monitors(), probe_key=1)
    on = make_bank_run_loop(bank, model, retrain_every=4, train_keys=range(Q), telemetry=tel)
    out_off = off(prng.key(5), batches, bcounts)
    _equal(out_off, on(prng.key(5), batches, bcounts))
    ticks = mem.by_kind("tick")
    assert [r["t"] for r in ticks] == list(range(T))
    assert mem.by_kind("run")[0]["scheme"] == "bank.rtbs"
    assert all(r["probe_key"] == 1 for r in ticks)
    assert [r["size"] for r in ticks] == out_off[2]["size"].tolist()     # [Q] columns
    assert [r["overflow"] for r in ticks] == out_off[2]["overflow"].tolist()
    w = 0.0
    for r in ticks:
        w = r["decay"] * w + r["probe_arrivals"]
        np.testing.assert_allclose(w, r["probe_total_weight"], rtol=1e-3, atol=1e-4)
    assert any(w_["monitor"] == "overflow_alarm" for w_ in mem.by_kind("warning"))
    # JAX's bank loop on the same configuration drains the same columns
    jb, jc = j_materialize_stream(JKeyedStream(base=JLinRegStream(seed=0), num_keys=K,
                                               seed=0), T, batch_size=24,
                                  fields=("key", "x", "y"))
    cols, _ = _jax_tick_columns(
        lambda tel_: j_make_bank_run_loop(
            j_make_bank("rtbs", num_keys=K, n=8, lam=0.1, bcap=2),
            j_make_model("linreg", dim=2), retrain_every=4, train_keys=range(Q),
            telemetry=tel_)(jax.random.key(5), jb, jc), T, 4)
    assert set(ticks[0]) == cols
    assert _check_file()(tmp_path / "b.jsonl") == []


def test_bank_loop_telemetry_per_key_controller():
    K, Q, T = 16, 3, 8
    batches, bcounts = _keyed(K=K, T=T)
    bank = make_bank("rtbs", num_keys=K, n=8, lam=0.1, bcap=8, device=CPU)
    model = make_model("linreg", dim=2, device=CPU)
    ctrl = loss_ratio(lam0=0.1, lam_min=0.02, lam_max=0.8)
    kw = dict(retrain_every=2, train_keys=range(Q), per_key=True, controller=ctrl)
    out_off = make_bank_run_loop(bank, model, **kw)(prng.key(2), batches, bcounts)
    mem = MemorySink()
    out_on = make_bank_run_loop(bank, model, telemetry=Telemetry([mem], every=3), **kw)(
        prng.key(2), batches, bcounts)
    _equal(out_off, out_on)
    ticks = mem.by_kind("tick")
    assert len(ticks) == T and {"lam", "hold", "pulse"} <= set(ticks[0])
    assert len(ticks[0]["metric"]) == Q


# ---------------------------------------------------------------------------
# the drivers' flags
# ---------------------------------------------------------------------------
def test_driver_telemetry_jsonl_passes_the_schema_check(tmp_path):
    from repro_torch.launch.train import main

    log = main(["--arch", "mamba2_370m", "--preset", "smoke", "--ticks", "4",
                "--batch-per-tick", "8", "--reservoir", "16", "--retrain-every", "2",
                "--retrain-steps", "1", "--train-batch", "4", "--seq-len", "16",
                "--telemetry-dir", str(tmp_path)], device=CPU)
    path = tmp_path / "telemetry.jsonl"
    assert _check_file()(path) == []
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    ticks = [r for r in recs if r["kind"] == "tick"]
    assert [r["metric"] for r in ticks] == [r["eval_loss"] for r in log]
    assert {"weight", "total_weight", "fill_frac", "decay"} <= set(ticks[0])


def test_loops_refuse_a_non_telemetry_handle():
    sampler = make_sampler("rtbs", n=4, lam=0.1, device=CPU)
    model = make_model("linreg", device=CPU)
    with pytest.raises(TypeError, match="Telemetry"):
        make_run_loop(sampler, model, telemetry=object())
