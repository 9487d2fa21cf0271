"""Roofline table: the dry-run records (``python -m
repro_torch.launch.dryrun``) as one markdown table, every term a cell,
the dominant one, the MODEL_FLOPS ratio and one device's memory (the port
of the JAX package's ``benchmarks/roofline.py``).  The terms are H100
predictions from data-sheet peaks (``launch/cost_analysis.py``), not
readings of a card.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.benchmarks import common
from repro_torch.launch import cost_analysis as C

DRYRUN_DIR = os.path.join(str(common.REPO), "experiments", "dryrun_torch")
#: the first line of every table made from the records
CAPTION = (f"Predictions from NVIDIA H100 SXM data-sheet peaks at 700 W "
           f"({C.PEAK_FLOPS:.4g} bf16 FLOP/s, {C.SIMT_OPS:.4g} CUDA-core "
           f"ops/s, {C.HBM_BW:.4g} HBM B/s, {C.NET_BW:.4g} network B/s a "
           f"GPU) and {C.COLL_LATENCY:.3g} s a collective (measured on the "
           f"card), one device of the mesh traced with fake tensors by "
           f"`python -m repro_torch.launch.dryrun`; not card readings.")


def caption(recs) -> str:
    """:data:`CAPTION` and the torch versions that traced ``recs``:
    DTensor's sharding choices, so a device's bytes, are the version's."""
    versions = sorted({r.get("traced", {}).get("torch", "unknown")
                       for r in recs})
    return (f"{CAPTION}  Traced under torch {', '.join(versions)}: each "
            f"device's bytes and whether it fits follow that version's "
            f"DTensor sharding choices.")


def load_records(mesh: str | None = None, include_tagged: bool = False):
    """The records under :data:`DRYRUN_DIR` (of ``mesh``, or all); a
    file name with a ``--tag`` suffix is a variant, left out unless
    ``include_tagged``."""
    recs = []
    for f in sorted(glob.glob(os.path.join(DRYRUN_DIR, "*.json"))):
        parts = os.path.basename(f)[:-5].split("__")
        tagged = len(parts) < 3 or parts[2] not in ("pod", "multipod")
        if tagged and not include_tagged:
            continue
        with open(f) as fh:
            r = json.load(fh)
        if mesh is None or r["mesh"] == mesh:
            recs.append(r)
    return recs


def fmt_row(r) -> str:
    rf = r["roofline"]
    mem = r["memory_analysis"]
    mfu = r.get("mfu_fraction")
    ur = rf.get("useful_ratio")
    return (f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {rf['compute_s']:.4f} | {rf['simt_s']:.4f} "
            f"| {rf['memory_s']:.4f} | {rf['collective_s']:.4f} "
            f"| {rf['latency_s']:.4f} "
            f"| {rf['dominant']} "
            f"| {mem['live_bytes_per_device'] / 1e9:.1f} "
            f"| {'' if ur is None else f'{ur:.2f}'} "
            f"| {'' if mfu is None else f'{mfu:.4f}'} |")


HEADER = ("| arch | shape | mesh | tensor_s | simt_s | memory_s "
          "| collective_s | latency_s | dominant | GB/dev | useful | mfu |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|---|")


def run(quick: bool = False):
    recs = load_records()
    if not recs:
        print("no dry-run records found; run "
              "`python -m repro_torch.launch.dryrun --all` first")
        return None
    lines = [caption(recs), "", HEADER] + [fmt_row(r) for r in recs]
    os.makedirs(common.OUT_DIR, exist_ok=True)
    out = os.path.join(common.OUT_DIR, "roofline_table.md")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    scored = sorted(((r["mfu_fraction"], r) for r in recs
                     if r.get("mfu_fraction")), key=lambda t: t[0])
    if scored:
        print("\nworst roofline fractions:")
        for v, r in scored[:3]:
            print(f"  {r['arch']} {r['shape']} {r['mesh']}: mfu={v:.4f} "
                  f"dominant={r['roofline']['dominant']}")
    return out


if __name__ == "__main__":
    run()
