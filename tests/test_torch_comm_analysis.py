"""``repro_torch.launch.comm_analysis`` (the twin of the JAX package's
``launch/hlo_analysis.py``) against JAX's own functions: the same
collectives written once as partitioned-HLO lines and once as the
``torch.profiler`` events a rank records (a ``c10d::*`` op and its
backend's execution event, in the trace's JSON form) give equal
``collective_stats`` dicts, for every family and element type, all-reduce's
factor of 2, all-gather's output bytes, the async halves counted once, and
cross-pod groups; the profiler's type names are the ones it records; and
``duplicate_fusion_ratio`` on hand-made events."""
import json

import pytest
import torch

from repro.launch import hlo_analysis as jh
from repro_torch.launch import comm_analysis as ca

# JAX's element types and the names torch.profiler records for them
PROFILER_TYPES = {"pred": "bool", "s8": "signed char", "u8": "unsigned char",
                  "s16": "short int", "u16": "short unsigned int", "bf16": "c10::BFloat16",
                  "f16": "c10::Half", "s32": "int", "u32": "unsigned int", "f32": "float",
                  "s64": "long int", "u64": "long unsigned int", "f64": "double",
                  "c64": "c10::complex<float>"}
TORCH_DTYPES = {"pred": torch.bool, "s8": torch.int8, "u8": torch.uint8, "s16": torch.int16,
                "u16": torch.uint16, "bf16": torch.bfloat16, "f16": torch.float16,
                "s32": torch.int32, "u32": torch.uint32, "f32": torch.float32,
                "s64": torch.int64, "u64": torch.uint64, "f64": torch.float64,
                "c64": torch.complex64}


class Trace:
    """A hand-written rank trace: each collective a ``c10d::*`` event and
    the backend event that runs it, in time order."""

    def __init__(self):
        self.events, self.ts = [], 0.0

    def _ev(self, name, dims, types, **args):
        self.ts += 10.0
        self.events.append({"ph": "X", "name": name, "ts": self.ts, "dur": 5.0,
                            "args": {"Input Dims": dims, "Input type": types, **args}})

    def backend(self, op, shape, dt):
        self._ev(f"gloo:{op}", [list(shape)], [PROFILER_TYPES[dt]])

    def all_gather(self, shape, dt, **args):            # dist.all_gather, list form
        self._ev("c10d::allgather_", [[], [list(shape)], [], [], []],
                 ["", "TensorList", "", "Scalar", "Scalar"], **args)
        self.backend("all_gather", shape, dt)

    def all_gather_into(self, out, shape, dt, **args):
        t = PROFILER_TYPES[dt]
        self._ev("c10d::_allgather_base_", [list(out), list(shape), [], [], []],
                 [t, t, "", "Scalar", "Scalar"], **args)
        self.backend("all_gather", shape, dt)

    def all_reduce(self, shape, dt, **args):
        self._ev("c10d::allreduce_", [[list(shape)], [], [], [], [], []],
                 ["TensorList", "", "", "", "Scalar", "Scalar"], **args)
        self.backend("all_reduce", shape, dt)

    def reduce_scatter(self, out, shape, dt, **args):
        t = PROFILER_TYPES[dt]
        self._ev("c10d::_reduce_scatter_base_", [list(out), list(shape), [], [], [], []],
                 [t, t, "", "", "Scalar", "Scalar"], **args)
        self.backend("all_reduce", shape, dt)

    def all_to_all(self, shape, dt, **args):
        t = PROFILER_TYPES[dt]
        self._ev("c10d::alltoall_base_", [list(shape), list(shape), [], [], [], [], []],
                 [t, t, "", "ScalarList", "ScalarList", "Scalar", "Scalar"], **args)
        self.backend("all_to_all", shape, dt)

    def send(self, shape, dt, **args):
        self._ev("c10d::send", [[list(shape)], [], [], []],
                 ["TensorList", "", "Scalar", "Scalar"], **args)
        self.backend("send", shape, dt)

    def other(self):
        """Ops JAX's families do not name: a barrier, a broadcast."""
        self._ev("c10d::barrier", [[1], [], [], [], []],
                 ["unsigned char", "", "ScalarList", "Scalar", "Scalar"])
        self._ev("gloo:barrier", [], [])
        self._ev("c10d::broadcast_", [[[7]], [], [], [], [], []],
                 ["TensorList", "", "Scalar", "Scalar", "Scalar", "Scalar"])
        self.backend("broadcast", (7,), "f32")


def _hlo_shape(dt, shape):
    return f"{dt}[{','.join(str(d) for d in shape)}]"


def _groups(ranks):
    return "{{" + ",".join(str(r) for r in ranks) + "}}"


def _pair(kind, dt, shape, G=4, ranks=None):
    """One collective as an HLO line and as trace events."""
    ranks = list(range(G)) if ranks is None else ranks
    rg = f", replica_groups={_groups(ranks)}"
    x = _hlo_shape(dt, shape)
    tr = Trace()
    args = {"Process Group Ranks": json.dumps(ranks)}
    if kind == "all-gather":
        out = (shape[0] * G,) + tuple(shape[1:])
        hlo = f"  %g = {_hlo_shape(dt, out)}{{0}} all-gather({x} %p){rg}, dimensions={{0}}"
        tr.all_gather(shape, dt, **args)
    elif kind == "all-gather-into":
        out = (shape[0] * G,) + tuple(shape[1:])
        hlo = f"  %g = {_hlo_shape(dt, out)}{{0}} all-gather({x} %p){rg}, dimensions={{0}}"
        tr.all_gather_into(out, shape, dt, **args)
    elif kind == "all-reduce":
        hlo = f"  %r = {x} all-reduce({x} %p){rg}, to_apply=%add"
        tr.all_reduce(shape, dt, **args)
    elif kind == "reduce-scatter":
        out = (shape[0] // G,) + tuple(shape[1:])
        hlo = f"  %s = {_hlo_shape(dt, out)} reduce-scatter({x} %p){rg}, dimensions={{0}}"
        tr.reduce_scatter(out, shape, dt, **args)
    elif kind == "all-to-all":
        hlo = f"  %a = {x} all-to-all({x} %p){rg}, dimensions={{0}}"
        tr.all_to_all(shape, dt, **args)
    else:
        hlo = (f"  %c = {x} collective-permute({x} %p), "
               f"source_target_pairs={{{{0,1}}}}{rg}")
        tr.send(shape, dt, **args)
    return hlo, tr.events


KINDS = ("all-gather", "all-gather-into", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def test_dtype_bytes_equal_jax():
    assert ca.DTYPE_BYTES == jh.DTYPE_BYTES
    assert set(PROFILER_TYPES) == set(jh.DTYPE_BYTES)


def test_profiler_records_the_type_names_the_twin_reads():
    """Every JAX element type's tensor, as ``torch.profiler`` names it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        for dt in TORCH_DTYPES.values():
            torch.empty(3, dtype=dt).clone()
    got = [e["args"]["Input type"][0] for e in ca.trace_events(prof)
           if e.get("name") == "aten::clone"]
    assert got == [PROFILER_TYPES[k] for k in TORCH_DTYPES]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dt", sorted(jh.DTYPE_BYTES))
def test_collective_stats_equal_jax_per_family_and_dtype(kind, dt):
    hlo, events = _pair(kind, dt, (8, 3))
    want = jh.collective_stats(hlo)
    got = ca.collective_stats(events)
    assert got == want
    assert sum(want["counts"].values()) == 1


def test_collective_stats_equal_jax_on_a_mixed_program_with_async_halves_and_pods():
    """Several collectives in one program: all-reduce's x2, all-gather's
    output bytes, an async all-reduce whose ``-done`` half (HLO) or backend
    event (trace) counts once, ops outside JAX's families, and groups that
    do or do not span two pods of 2 ranks (``dcn``)."""
    lines, events = [], []
    for kind, dt, shape, ranks in (("all-gather", "f32", (4, 5), [0, 1]),
                                   ("all-reduce", "bf16", (6,), [0, 2]),
                                   ("all-reduce", "s64", (3, 2), [0, 1]),
                                   ("reduce-scatter", "f16", (8, 2), [1, 3]),
                                   ("all-to-all", "u8", (4,), [2, 3]),
                                   ("all-gather-into", "pred", (2, 2), [0, 1, 2, 3]),
                                   ("collective-permute", "s32", (5,), [0, 1])):
        hlo, ev = _pair(kind, dt, shape, G=len(ranks), ranks=ranks)
        lines.append(hlo)
        events.extend(e | {"ts": e["ts"] + 100.0 * len(lines)} for e in ev)
    # an async all-reduce: start / done in HLO; in the trace its c10d op,
    # the backend's run of it and the wait
    lines += ["  %st = f32[16]{0} all-reduce-start(f32[16]{0} %q), replica_groups={{0,1}}",
              "  %dn = f32[16]{0} all-reduce-done(f32[16]{0} %st)"]
    tr = Trace()
    tr.ts = 10_000.0
    tr.all_reduce((16,), "f32", **{"Process Group Ranks": "[0, 1]"})
    tr.other()
    tr._ev("c10d::wait", [], [])
    events += tr.events
    want = jh.collective_stats("\n".join(lines), pod_size=2)
    got = ca.collective_stats(events, pod_size=2)
    assert got == want
    assert want["counts"]["all-reduce"] == 3 and want["bytes"]["dcn"] > 0
    # without the groups' ranks no collective is known to cross a pod
    bare = [dict(e, args={k: v for k, v in e["args"].items() if k != "Process Group Ranks"})
            for e in events]
    assert "dcn" not in ca.collective_stats(bare, pod_size=2, group_size=2)["bytes"]


def test_list_all_gather_needs_the_group_size_and_a_dtype():
    tr = Trace()
    tr.all_gather((2, 3), "f32")
    with pytest.raises(ValueError, match="group_size"):
        ca.collective_stats(tr.events)
    assert ca.collective_stats(tr.events, group_size=4)["bytes"]["all-gather"] == 96
    tr.events[0]["args"]["Group size"] = 2
    assert ca.collective_stats(tr.events, group_size=4)["bytes"]["all-gather"] == 48
    with pytest.raises(ValueError, match="no backend event"):
        ca.collective_stats(tr.events[:1], group_size=4)


def test_duplicate_fusion_ratio_on_hand_made_events():
    def mm(name, *dims):
        return {"name": name, "ts": 0.0, "args": {"Input Dims": [list(d) for d in dims]}}

    events = [mm("aten::mm", (4, 8), (8, 2)), mm("aten::mm", (4, 8), (8, 2)),
              mm("aten::addmm", (2,), (4, 8), (8, 2)), mm("aten::bmm", (3, 4, 8), (3, 8, 2)),
              mm("aten::mm", (4, 8), (8, 2)), mm("aten::add", (4,), (4,))]
    assert ca.duplicate_fusion_ratio(events) == pytest.approx(1 - 3 / 5)
    assert ca.duplicate_fusion_ratio([mm("aten::add", (1,), (1,))]) == 0.0
    hlo = "\n".join(["%d = f32[4,2] dot(f32[4,8] %a, f32[8,2] %b)"] * 2
                    + ["%e = f32[4,2] dot(f32[4,8] %c, f32[8,2] %b)"])
    assert ca.duplicate_fusion_ratio([mm("aten::mm", (4, 8), (8, 2))] * 2
                                     + [mm("aten::mm", (4, 8), (8, 3))]) \
        == pytest.approx(jh.duplicate_fusion_ratio(hlo))
