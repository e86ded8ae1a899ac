#!/usr/bin/env python3
"""K1/K2 (GroupNorm+SiLU forward/backward) by shape, from ``chip_smoke.py --out`` reports.

    python3 scripts/torch_gn_table.py --change a.json [b.json] --parent p.json [q.json]

Reads the training-step rows (``train_kernels.shapes``: batch 128) and the
serving rows (``shapes``: K1's site in a forward with both switches on, at
batch 1, 8 and 16) of each report and
prints one markdown row per (kernel, shape): call sites, this tree's ms a
call in each ``--change`` report, the ms in each ``--parent`` report (the
parent's own ``chip_smoke.py`` run in the same call), the byte bound, the
``F.group_norm`` + ``F.silu`` sequence (its autograd for K2), the launch
plan and the registers and spill bytes of the one-pass kernel. Rows of one
shape with and without a pre-bias are merged, their times weighted by
sites. Then the totals a training step, for each report.
"""

from __future__ import annotations

import argparse
import ast
import json

KERNELS = {"group_norm_silu": ("K1", "gn_fwd_cluster_kernel"),
           "group_norm_silu_bwd": ("K2", "gn_bwd_cluster_kernel")}


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def train_rows(report: dict) -> dict:
    """{(kernel, shape): [sites, Σ ms·sites, Σ bound·sites, Σ seq·sites, plan]}"""
    out = {}
    for r in report.get("train_kernels", {}).get("shapes", []):
        if r["kernel"] not in KERNELS:
            continue
        shape = tuple(ast.literal_eval(r["key"])[0])
        e = out.setdefault((r["kernel"], shape), [0, 0.0, 0.0, 0.0, None])
        e[0] += r["sites"]
        e[1] += r["ms"] * r["sites"]
        e[2] += r["bound_ms"] * r["sites"]
        e[3] += (r.get("torch_seq_ms") or 0.0) * r["sites"]
        e[4] = r.get("plan")
    return out


def serve_rows(report: dict) -> dict:
    """K1's one site of a serving forward (both switches on) at each batch."""
    out = {}
    for r in report.get("shapes", []):
        if r["kernel"] != "group_norm_silu" or not any(k.startswith("both") for k in r["sites"]):
            continue
        shape = tuple(ast.literal_eval(r["key"])[0])
        out[("group_norm_silu", shape)] = [1, r["ms"], r["bound_ms"],
                                           r.get("torch_seq_ms") or 0.0, r.get("plan")]
    return out


def registers(report: dict) -> dict:
    regs = {}
    for name, u in report.get("ptxas", {}).get("group_norm", {}).items():
        for kernel, (_, needle) in KERNELS.items():
            # the kernels are templated on the element type: the bf16 instance
            if needle in name and ("<" not in name or "bfloat16" in name):
                regs[kernel] = f"{u['registers']} / {u['spill_stores']}+{u['spill_loads']} B"
    return regs


def plan_text(plan) -> str:
    if not plan:
        return "—"
    if plan["two_pass"]:
        return f"two passes, {plan['blocks']} chunks of {plan['pixels']} px"
    return f"cluster {plan['blocks']} × {plan['pixels']} px, {plan['threads']} thr"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--change", nargs="+", required=True)
    ap.add_argument("--parent", nargs="*", default=[])
    args = ap.parse_args()
    change = [load(p) for p in args.change]
    parent = [load(p) for p in args.parent]
    print(f"card: {change[0].get('card')}")
    regs = registers(change[0])
    rows = {}
    for i, rep in enumerate(change):
        for key, e in {**train_rows(rep), **serve_rows(rep)}.items():
            rows.setdefault(key, {"change": [], "parent": [], "e": e})["change"].append(e)
    for rep in parent:
        for key, e in {**train_rows(rep), **serve_rows(rep)}.items():
            if key in rows:
                rows[key]["parent"].append(e)
    print("| kernel | (N, H, W, C) | sites | ms a call (this PR) | ms a call (parent) | bound ms"
          " | torch seq ms | plan | registers / spills |")
    print("|---|---|---|---|---|---|---|---|---|")
    for (kernel, shape), v in sorted(rows.items(), key=lambda kv: (kv[0][0], kv[0][1])):
        sites, _, bound, seq, plan = v["e"]

        def per_call(es):
            return " / ".join(f"{e[1] / e[0]:.4f}" for e in es) or "—"

        print(f"| {KERNELS[kernel][0]} | {shape} | {sites} | {per_call(v['change'])} | "
              f"{per_call(v['parent'])} | {bound / sites:.4f} | "
              f"{seq / sites:.4f} | {plan_text(plan)} | {regs.get(kernel, '—')} |")
    for label, reps in (("this PR", change), ("parent", parent)):
        for rep in reps:
            ps = rep.get("train_kernels", {}).get("per_step", {})
            print(f"{label}: per batch-128 step " + ", ".join(
                f"{KERNELS[k][0]} {ps[k]['ms']:.4f} ms (bound {ps[k]['bound_ms']:.4f})"
                for k in KERNELS if k in ps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
