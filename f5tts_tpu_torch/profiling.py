"""Tracing and profiling utilities (counterpart of f5tts_tpu/profiling.py).

The port's equivalent of the reference's NVTX stage ranges
(src/f5_tts/runtime/triton_trtllm/model_repo_f5_tts/f5_tts/1/model.py:186-268)
and of the JAX package's jax.profiler helpers:

- `StageTimer.stage(name, sync)`: a wall-clock stage timer inside a
  `torch.profiler.record_function` range (preprocess / sampler / vocoder
  splits), `report()` as the JAX one's;
- `device_trace(logdir)`: a `torch.profiler` trace (the CPU, and the card's
  kernels through CUPTI where there is one) written as a Chrome trace
  (`*.pt.trace.json.gz`, chrome://tracing or Perfetto) into `logdir`;
- `annotate(name)`: `torch.profiler.record_function`, a range in the trace;
- `summarize_trace(logdir)`: the kernel time of the newest trace by kernel
  or by the operator that launched it.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import NamedTuple

import torch

annotate = torch.profiler.record_function


class StageTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = False):
        """Time the block as stage `name`. With `sync`, wait for the card's
        queued work before the clock stops (accurate splits); without it the
        caller syncs on its outputs."""
        t0 = time.perf_counter()
        with annotate(name):
            yield
            if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {"total_s": round(self.totals[name], 4),
                   "count": self.counts[name],
                   "avg_ms": round(self.totals[name] / self.counts[name] * 1000, 3)}
            for name in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(logdir: str = os.path.join(tempfile.gettempdir(), "f5tts-torch-trace")):
    """Profile the block (CPU, and CUDA where a card is present) and write
    its Chrome trace to `logdir`/<pid>.<time>.pt.trace.json.gz."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, f"{os.getpid()}.{time.time_ns()}"
                                                  ".pt.trace.json.gz"))


class _Kernel(NamedTuple):
    """A trace event as `scripts.common.device_time_by_class` reads one."""

    name: str
    time_range: NamedTuple
    device_type: object = torch.autograd.DeviceType.CUDA


class _Range(NamedTuple):
    start: float
    end: float


class _Events(NamedTuple):
    kernels: list

    def events(self):
        return self.kernels


def _stem(name: str) -> str:
    """A kernel's name without "void " and its argument list."""
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0]


def _launching_ops(events: list) -> dict:
    """correlation id -> the innermost CPU operator around the runtime call
    (cudaLaunchKernel and the like) that carries that id."""
    by_track = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "cuda_runtime"):
            by_track[(e.get("pid"), e.get("tid"))].append(e)
    out = {}
    for track in by_track.values():
        # operators before the calls they enclose, the outer one first
        track.sort(key=lambda e: (e["ts"], e["cat"] == "cuda_runtime", -e.get("dur", 0)))
        stack = []  # the open operators
        for e in track:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < e["ts"] + e.get("dur", 0):
                stack.pop()
            if e["cat"] == "cpu_op":
                stack.append(e)
            elif stack and (e.get("args") or {}).get("correlation") is not None:
                out[e["args"]["correlation"]] = stack[-1]["name"]
    return out


def summarize_trace(logdir: str, steps: int = 1, top: int = 25,
                    key: str = "source") -> list[tuple[str, float, int]]:
    """The newest `*.trace.json[.gz]` under `logdir`, broken down by leaf
    kernel events, as the JAX package's summarize_trace breaks down its XLA
    ops: an event that strictly encloses another on its (pid, tid) track is
    a parent and is left out, so nothing is counted twice. `key` picks the
    aggregation: "source" (the operator that launched the kernel, such as
    f5tts::adaln_norm or aten::mm, else the kernel's name stem) or "op" (the
    kernel's name stem: without "void " and its argument list). Returns
    [(key, ms_total, calls)] sorted by time, and prints the top rows."""
    from f5tts_tpu_torch.scripts.common import device_time_by_class

    paths = glob.glob(os.path.join(logdir, "**", "*.trace.json*"), recursive=True)
    if not paths:
        raise SystemExit(f"no trace under {logdir}")
    path = max(paths, key=os.path.getmtime)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    by_op = _launching_ops(events) if key == "source" else {}

    by_track = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            by_track[(e.get("pid"), e.get("tid"))].append(e)
    leaves = []
    for track in by_track.values():
        track.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []  # (end_ts, event); children mark parents non-leaf
        leaf_flags = {}
        for e in track:
            ts, dur = e["ts"], e.get("dur", 0)
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if stack:
                leaf_flags[id(stack[-1][1])] = False
            leaf_flags.setdefault(id(e), True)
            stack.append((ts + dur, e))
        for e in track:
            if leaf_flags.get(id(e), True):
                stem = _stem(e["name"])
                name = by_op.get((e.get("args") or {}).get("correlation"), stem)
                leaves.append(_Kernel(name, _Range(e["ts"], e["ts"] + e.get("dur", 0))))

    table = device_time_by_class(_Events(leaves), (), top=len(leaves)).get("top_kernels", {})
    rows = [(k, v["ms"], v["launches"]) for k, v in table.items()]
    total = sum(r[1] for r in rows)
    print(f"trace: {path}")
    print(f"total (leaf kernels): {total / steps:.3f} ms/step over {steps} steps")
    for k, ms, n in rows[:top]:
        print(f"{ms / steps:9.3f} ms/step {100 * ms / max(total, 1e-9):5.1f}%  n={n:6d}  {k}")
    return rows
