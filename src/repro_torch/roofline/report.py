"""Render the tables of the port's dry-run records
(``experiments/dryrun_torch/*.json``, ``launch.dryrun``).  Counterpart of
``repro/roofline/report.py``; the records carry JAX's keys, so the table
is JAX's.

    PYTHONPATH=src python -m repro_torch.roofline.report [--mesh sp|mp] [--tag t]
"""
from __future__ import annotations

import argparse
import json

from ..launch.dryrun import OUT_DIR as DRY

ARCH_ORDER = ["rwkv6-7b", "gemma3-12b", "qwen2-moe-a2.7b", "hubert-xlarge",
              "llama3-405b", "deepseek-v3-671b", "granite-20b",
              "llava-next-34b", "gemma3-4b", "jamba-v0.1-52b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh_tag: str, extra: str = ""):
    recs = {}
    suffix = f"__{mesh_tag}{extra}.json"
    for f in sorted(DRY.glob(f"*{suffix}")):
        r = json.loads(f.read_text())
        recs[(r["arch"], r["shape"])] = r
    return recs


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def table(recs, *, show_mem=True) -> str:
    head = ("| arch | shape | compute (ms) | memory (ms) | collective (ms) |"
            " dominant | useful | args/dev GiB | temp/dev GiB | coll GB/dev |"
            " AR/AG/RS/A2A GB |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|\n")
    out = [head]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s))
            if r is None:
                continue
            if "skipped" in r:
                out.append(f"| {a} | {s} | — | — | — | SKIP | — | — | — | — |"
                           f" {r['skipped'][:58]} |\n")
                continue
            if "error" in r:
                out.append(f"| {a} | {s} | ERROR | | | | | | | | |\n")
                continue
            t = r["roofline"]
            m = r["memory"]
            c = r["collectives"]
            kinds = "/".join(f"{c.get(k,0)/1e9:.1f}" for k in
                             ("all-reduce", "all-gather", "reduce-scatter",
                              "all-to-all"))
            out.append(
                f"| {a} | {s} | {t['compute_s']*1e3:.1f} | "
                f"{t['memory_s']*1e3:.1f} | {t['collective_s']*1e3:.1f} | "
                f"{t['dominant'].replace('_s','')} | "
                f"{t['useful_flops_ratio']:.2f} | "
                f"{fmt_bytes(m['argument_bytes'])} | "
                f"{fmt_bytes(m['temp_bytes'])} | "
                f"{t['collective_bytes_per_dev']/1e9:.1f} | {kinds} |\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="sp", choices=["sp", "mp"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    recs = load(args.mesh, f"__{args.tag}" if args.tag else "")
    print(table(recs))


if __name__ == "__main__":
    main()
