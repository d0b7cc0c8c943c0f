"""Aggregate dry-run JSONL records into tables: the port's copy of
``repro/roofline/report.py``, its HBM column flagged against the H100's
80 GB (``HBM_GB``).

    python -m repro_torch.roofline.report RECORDS.jsonl [--hints]
"""
from __future__ import annotations

import argparse
import json
from typing import List

HBM_GB = 80  # the H100's device memory


def load(path: str) -> List[dict]:
    """The records of a JSONL file."""
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def fmt_s(x: float) -> str:
    """Seconds, short."""
    if x == 0:
        return "0"
    if x >= 0.01:
        return f"{x:.2f}"
    return f"{x:.1e}"


def markdown_table(recs: List[dict]) -> str:
    """One row per record: the three terms, the dominant one, the useful
    share, the MFU bound and the per-device footprint."""
    header = (
        "| arch | shape | C (s) | M (s) | X (s) | dominant | useful | "
        "mfu<= | HBM/dev | note |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for r in recs:
        hbm = r["hbm_bytes_per_device"] / 1e9
        fits = "" if hbm <= HBM_GB else f"**>{HBM_GB}G**"
        rows.append(
            f"| {r['arch_id']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['dominant']} | {r['useful_flops_ratio']:.1%} | "
            f"{r['mfu_upper_bound']:.1%} | {hbm:.1f}G | {fits} |"
        )
    return header + "\n".join(rows) + "\n"


def one_liner_per_pair(recs: List[dict]) -> str:
    """The required 'what would move the dominant term down' sentence."""
    out = []
    for r in recs:
        dom = r["dominant"]
        if dom == "collective":
            kinds = r["collective_breakdown"]
            top = max(kinds, key=kinds.get)
            hint = {
                "all-gather": "keep activations sharded through the tail "
                "(megatron pairing) or reduce TP degree for this size",
                "all-reduce": "replace the gather+replicated-tail with a "
                "row-parallel reduce-scatter, or fold model into the data axis",
                "reduce-scatter": "already paired; next lever is TP degree",
                "all-to-all": "larger expert capacity granularity / fewer "
                "expert shards per token batch",
                "collective-permute": "reorder the mesh so the sharded axis "
                "is NVLink-contiguous",
            }.get(top, "reduce TP degree")
            out.append(f"- {r['arch_id']}/{r['shape']}: collective-bound "
                       f"({top}); {hint}.")
        elif dom == "memory":
            out.append(
                f"- {r['arch_id']}/{r['shape']}: memory-bound; shard the "
                "dominant resident tensor further (FSDP the params/opt state, "
                "shard the KV cache over batch/heads) or raise arithmetic "
                "intensity (fuse, larger per-device batch)."
            )
        else:
            out.append(
                f"- {r['arch_id']}/{r['shape']}: compute-bound; reduce "
                "redundant FLOPs (remat policy, replicated tail) — "
                f"useful ratio {r['useful_flops_ratio']:.1%}."
            )
    return "\n".join(out) + "\n"


def main():
    """The command line: print the table (and with ``--hints`` the hints)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl")
    ap.add_argument("--hints", action="store_true")
    args = ap.parse_args()
    recs = load(args.jsonl)
    print(markdown_table(recs))
    if args.hints:
        print(one_liner_per_pair(recs))


if __name__ == "__main__":
    main()
