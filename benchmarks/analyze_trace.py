"""Exclusive-self-time breakdown of a jax.profiler trace (xplane).

Summing op durations double-counts nested spans, so self time per op =
span minus the union of child spans on the same line (stack pass over the
GPU device plane's "XLA Ops" line, or its per-stream kernel lines when the
trace has no such line). Prints the top ops and a coarse phase aggregation,
in which the Pallas select kernel (Triton custom calls, kernel name
``pool_select``) is its own phase.

Usage: python benchmarks/analyze_trace.py /tmp/trace_dir [--iters 10]
       (pass the directory given to jax.profiler.trace)
"""
from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path


def find_xplane(root: Path) -> Path:
    cands = sorted(root.rglob("*.xplane.pb"))
    if not cands:
        raise SystemExit(f"no .xplane.pb under {root}")
    return cands[-1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--iters", type=int, default=10,
                    help="scan length to divide by (per-iteration numbers)")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()

    from jax.profiler import ProfileData

    pd = ProfileData.from_file(str(find_xplane(Path(args.trace_dir))))
    device_planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not device_planes:
        raise SystemExit(
            "no GPU device plane in the trace: "
            + ", ".join(p.name for p in pd.planes)
        )
    for plane in device_planes:
        lines = [ln for ln in plane.lines if ln.name == "XLA Ops"] or [
            ln for ln in plane.lines if ln.name.startswith("Stream")
        ]
        for line in lines:
            evs = sorted(
                ((e.start_ns, e.end_ns, e.name) for e in line.events),
                key=lambda t: (t[0], -t[1]),
            )
            # Stack pass: exclusive time = span - children spans.
            self_ns = defaultdict(float)
            total_ns = defaultdict(float)
            count = defaultdict(int)
            stack = []  # (start, end, name, child_ns)
            for s, e, name in evs:
                while stack and s >= stack[-1][1]:
                    st, en, nm, ch = stack.pop()
                    self_ns[nm] += (en - st) - ch
                    if stack:
                        stack[-1][3] += en - st
                if stack and e > stack[-1][1]:
                    e = stack[-1][1]  # clip malformed overlap
                total_ns[name] += e - s
                count[name] += 1
                stack.append([s, e, name, 0.0])
            while stack:
                st, en, nm, ch = stack.pop()
                self_ns[nm] += (en - st) - ch
                if stack:
                    stack[-1][3] += en - st

            wall = sum(self_ns.values())
            print(f"\n== {plane.name} / {line.name}: "
                  f"self-time total {wall / 1e6:.2f} ms "
                  f"({wall / 1e6 / args.iters:.3f} ms/iter) ==")
            rows = sorted(self_ns.items(), key=lambda kv: -kv[1])
            for name, ns in rows[: args.top]:
                print(
                    f"{ns / 1e6 / args.iters:9.3f} ms/iter  x{count[name]:<5d}"
                    f" {name[:110]}"
                )
            # Coarse phases by name heuristics.
            phases = defaultdict(float)
            for name, ns in self_ns.items():
                n = name.lower()
                if "pool_select" in n or "triton" in n or "custom-call" in n:
                    phases["pallas kernels"] += ns
                elif "sort" in n:
                    phases["sort"] += ns
                elif "scatter" in n:
                    phases["scatter"] += ns
                elif "gather" in n or "dynamic-slice" in n:
                    phases["gather/slice"] += ns
                elif "dynamic-update" in n:
                    phases["dus"] += ns
                elif "copy" in n or "bitcast" in n or "transpose" in n:
                    phases["copies/layout"] += ns
                elif "fusion" in n:
                    phases["fusions"] += ns
                else:
                    phases["other"] += ns
            print("-- phases --")
            for k, v in sorted(phases.items(), key=lambda kv: -kv[1]):
                print(f"{v / 1e6 / args.iters:9.3f} ms/iter  {k}")


if __name__ == "__main__":
    main()
