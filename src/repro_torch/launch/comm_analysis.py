"""Collective traffic of a ``torch.profiler`` trace (the JAX package's
``launch/hlo_analysis.py``, which parses compiled HLO text).

:func:`collective_stats` reads the ``c10d::*`` events of a trace (the
process-group ops a rank issued) and sums, per collective family, the
PER-RANK payload bytes in JAX's convention, under JAX's family names:

  all-gather         -> output bytes        (each rank receives out - in)
  reduce-scatter     -> input bytes
  all-reduce         -> 2 x input bytes     (reduce-scatter + all-gather)
  all-to-all         -> input bytes
  collective-permute -> input bytes         (a ``send``)

Each collective counts once: the backend's execution of it (a ``gloo:*`` or
``nccl:*`` event, the trace's counterpart of HLO's ``-done`` half) is not
counted again. A ``c10d`` op records its tensors' dims and dtypes, except
for tensor lists (``dist.all_gather``'s list form, ``all_reduce``), whose
dtype is read from the backend event that executes it: the next one after
it with the same dims. A list-form all-gather records no output, so its
output is its input times the group's size (the event's ``Group size``
arg, else the number of its group's ranks, else ``group_size=``). A
collective is cross-pod (``dcn``) when its group's ranks (the event's
``Process Group Ranks`` arg) span two pods of ``pod_size`` ranks.

:func:`duplicate_fusion_ratio` is the eager analogue of JAX's redundancy
indicator: the share of matrix-product events (``aten::mm``, ``bmm``,
``addmm``) whose input dims repeat another's.

Events are a trace's ``traceEvents`` (dicts with ``name``, ``ts`` and
``args``), as :func:`trace_events` loads them from a profiler run (with
``record_shapes=True``) or its exported JSON.
"""
from __future__ import annotations

import ast
import json
import os
import tempfile
from collections import defaultdict

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
}

# the profiler's element type names, as JAX names them
_TYPES = {"bool": "pred", "signed char": "s8", "unsigned char": "u8", "short int": "s16",
          "short unsigned int": "u16", "c10::BFloat16": "bf16", "c10::Half": "f16",
          "int": "s32", "unsigned int": "u32", "float": "f32", "long int": "s64",
          "long unsigned int": "u64", "double": "f64", "c10::complex<float>": "c64"}

# c10d op -> (family, index of its input, index of its output or None)
_OPS = {"allgather_": ("all-gather", 1, None),
        "_allgather_base_": ("all-gather", 1, 0),
        "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
        "allreduce_": ("all-reduce", 0, None),
        "allreduce_coalesced_": ("all-reduce", 0, None),
        "reduce_scatter_": ("reduce-scatter", 1, 0),
        "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
        "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
        "alltoall_": ("all-to-all", 1, 0),
        "alltoall_base_": ("all-to-all", 1, 0),
        "send": ("collective-permute", 0, None)}
_BACKENDS = ("gloo:", "nccl:", "mpi:", "ucc:", "xccl:")


def trace_events(source) -> list:
    """The ``traceEvents`` of a ``torch.profiler.profile`` (exported to a
    temporary file), of a trace JSON's path, or a list of events as is."""
    if isinstance(source, list):
        return source
    if hasattr(source, "export_chrome_trace"):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            source.export_chrome_trace(path)
            return trace_events(path)
        finally:
            os.unlink(path)
    with open(source) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _numel(dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _is_list(dims) -> bool:
    return bool(dims) and isinstance(dims[0], list)


def _elems(dims) -> int:
    """Elements of a tensor's dims, or of every tensor of a list's."""
    return sum(_numel(d) for d in dims) if _is_list(dims) else _numel(dims)


def _ranks(e: dict):
    r = e.get("args", {}).get("Process Group Ranks")
    return ast.literal_eval(r) if isinstance(r, str) else r


def _collectives(events, group_size):
    """(family, bytes, ranks) for each c10d collective of ``events``."""
    evs = sorted((e for e in events if isinstance(e.get("name"), str) and "ts" in e),
                 key=lambda e: float(e["ts"]))
    used = set()
    for i, e in enumerate(evs):
        name = e["name"]
        if not name.startswith("c10d::") or name[6:] not in _OPS:
            continue
        kind, at_in, at_out = _OPS[name[6:]]
        args = e.get("args", {})
        dims, types = args.get("Input Dims", []), args.get("Input type", [])
        d_in, t_in = dims[at_in], types[at_in]
        if t_in == "TensorList":   # the dtype is the executing backend event's
            run = next((j for j in range(i + 1, len(evs)) if j not in used
                        and evs[j]["name"].startswith(_BACKENDS)
                        and evs[j].get("args", {}).get("Input Dims", [None])[0]
                        == (d_in[0] if _is_list(d_in) and d_in else d_in)), None)
            if run is None:
                raise ValueError(f"{name} at ts {e['ts']}: no backend event gives its dtype")
            used.add(run)
            t_in = evs[run]["args"]["Input type"][0]
        if t_in not in _TYPES:
            raise ValueError(f"{name}: element type {t_in!r} has no JAX name")
        width = DTYPE_BYTES[_TYPES[t_in]]
        grp = _ranks(e)
        if kind == "all-gather":
            if at_out is not None and dims[at_out]:
                size = _elems(dims[at_out]) * width
            else:
                g = int(args.get("Group size", len(grp) if grp else group_size or 0))
                if g < 1:
                    raise ValueError(f"{name}: a list-form all-gather records no output; "
                                     "pass group_size=")
                size = g * _elems(d_in) * width
        else:
            size = _elems(d_in) * width
        if kind == "all-reduce":
            size *= 2
        yield kind, size, grp


def collective_stats(events, *, pod_size: int = 1 << 30,
                     group_size: int | None = None) -> dict:
    """Returns ``{"bytes": {family: bytes, ..., "total", "dcn"}, "counts":
    {family: n}}`` for the collectives of ``events`` (JAX's
    ``collective_stats``; the module docstring's conventions)."""
    out = defaultdict(float)
    counts = defaultdict(int)
    for kind, size, grp in _collectives(trace_events(events), group_size):
        out[kind] += size
        counts[kind] += 1
        if grp and max(grp) // pod_size != min(grp) // pod_size:
            out["dcn"] += size
    out["total"] = sum(v for k, v in out.items() if k != "dcn")
    return {"bytes": dict(out), "counts": dict(counts)}


_MATMULS = ("aten::mm", "aten::bmm", "aten::addmm")


def duplicate_fusion_ratio(events) -> float:
    """Crude remat/redundancy indicator (JAX's, over HLO dots): the share of
    matrix-product events whose input dims repeat an earlier one's."""
    dots = [json.dumps(e.get("args", {}).get("Input Dims"))
            for e in trace_events(events) if e.get("name") in _MATMULS]
    if not dots:
        return 0.0
    return 1.0 - len(set(dots)) / len(dots)
