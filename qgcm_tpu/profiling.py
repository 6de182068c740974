"""Per-kernel profiling: capture + aggregate XLA device traces.

The reference has no profiler of its own (timing is hand-inserted
walltime prints in q-gcm.F:1380-1420); here `jax.profiler.trace`
wraps a steady-state chunk of the time loop (`qgcm run --profile`) and
the trace is aggregated into a per-op device-time table.

The trace protocol: `summarize(dir)` loads the newest
`*.trace.json.gz` under `dir/plugins/profile/` and sums complete
("X") events on the DEVICE processes ('/device:GPU:0 ...'): their
"XLA Ops" threads where the trace has them, else all their threads
(a GPU trace holds one per stream). Host-side Python/dispatch rows are
excluded, and so are the "XLA Modules" thread and while/conditional
container ops, whose spans cover their children and would
double-count. Events keep their `hlo_category` and `source` args, so
the report answers both "what kind of op" (matmul/fusion/data
formatting/collective) and "which line of ours" the device time
belongs to.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict

__all__ = ["summarize", "top_ops", "ProfileSummary"]

# Container HLO categories whose duration covers their children.
_CONTAINERS = {"while", "conditional", "call"}


def _load_trace(profile_dir: str) -> dict:
    pats = sorted(glob.glob(os.path.join(
        profile_dir, "plugins", "profile", "*", "*.trace.json.gz")))
    if not pats:
        raise FileNotFoundError(
            f"no trace files under {profile_dir}/plugins/profile")
    with gzip.open(pats[-1], "rt") as f:
        return json.load(f)


def _device_tids(events):
    """(pid, tid) -> "process/thread" name for the tracks holding device
    leaf ops.

    Device processes are named '/device:GPU:0' etc.; within one, the
    'XLA Ops' thread holds the leaf op events ('XLA Modules' holds
    whole-program spans). The CPU backend has no device process; fall
    back to any thread whose name is 'XLA Ops', else all threads.
    """
    pnames, tnames = {}, {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        if ev.get("name") == "process_name":
            pnames[ev["pid"]] = ev.get("args", {}).get("name", "")
        elif ev.get("name") == "thread_name":
            tnames[(ev["pid"], ev.get("tid"))] = \
                ev.get("args", {}).get("name", "")
    dev_pids = {pid for pid, n in pnames.items()
                if "device" in n.lower() or "gpu" in n.lower()}
    op_tids = {k for k, n in tnames.items() if n == "XLA Ops"}
    if dev_pids:
        sel = ({k for k in op_tids if k[0] in dev_pids}
               or {k for k in tnames if k[0] in dev_pids})
    else:
        sel = op_tids or set(tnames)
    return {k: f"{pnames.get(k[0], '?')}/{tnames.get(k, '?')}"
            for k in sel}


class ProfileSummary:
    def __init__(self, per_op, per_cat, per_src, total_us, wall_us,
                 tracks=()):
        self.tracks = tracks          # "process/thread" names summed
        self.per_op = per_op          # name -> device us
        self.per_cat = per_cat        # hlo_category -> device us
        self.per_src = per_src        # source file:line -> device us
        self.total_us = total_us      # summed leaf device op time
        self.wall_us = wall_us        # device-track span

    def top(self, n=15):
        return sorted(self.per_op.items(), key=lambda kv: -kv[1])[:n]

    def buckets(self):
        return dict(self.per_cat)

    def top_sources(self, n=10):
        return sorted(self.per_src.items(), key=lambda kv: -kv[1])[:n]

    def report(self, steps: int = 1) -> str:
        s = max(steps, 1)
        lines = [f"device op time: {self.total_us/1e3:.2f} ms over "
                 f"{steps} step(s) = {self.total_us/1e3/s:.3f} ms/step "
                 f"(track span {self.wall_us/1e3:.2f} ms)"]
        lines.append("  by kind: " + "  ".join(
            f"{k}={v/1e3/s:.3f}ms"
            for k, v in sorted(self.buckets().items(),
                               key=lambda kv: -kv[1]) if v > 0))
        lines.append("  top ops (ms/step):")
        for name, us in self.top():
            lines.append(f"    {us/1e3/s:9.4f}  {name[:90]}")
        srcs = [kv for kv in self.top_sources() if kv[0] != "?"]
        if srcs:
            lines.append("  top sources (ms/step):")
            for src, us in srcs:
                lines.append(f"    {us/1e3/s:9.4f}  {src}")
        return "\n".join(lines)


def summarize(profile_dir: str) -> ProfileSummary:
    data = _load_trace(profile_dir)
    events = data.get("traceEvents", [])
    tids = _device_tids(events)
    per_op = defaultdict(float)
    per_cat = defaultdict(float)
    per_src = defaultdict(float)
    t0, t1 = float("inf"), 0.0
    for ev in events:
        if ev.get("ph") != "X" or (ev.get("pid"), ev.get("tid")) not in tids:
            continue
        dur = float(ev.get("dur", 0.0))
        if dur <= 0:
            continue
        args = ev.get("args", {})
        cat = args.get("hlo_category", "?")
        if cat in _CONTAINERS:
            continue
        per_op[ev.get("name", "?")] += dur
        per_cat[cat] += dur
        src = args.get("source")
        if src:
            per_src[src] += dur
        ts = float(ev.get("ts", 0.0))
        t0, t1 = min(t0, ts), max(t1, ts + dur)
    total = sum(per_op.values())
    wall = (t1 - t0) if t1 > t0 else total
    return ProfileSummary(dict(per_op), dict(per_cat), dict(per_src),
                          total, wall, tuple(sorted(set(tids.values()))))


def top_ops(profile_dir: str, n: int = 15):
    return summarize(profile_dir).top(n)
