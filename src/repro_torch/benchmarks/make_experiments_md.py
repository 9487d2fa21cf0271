"""Assemble EXPERIMENTS_torch.md from the port's bench records — the port
of the JAX package's ``benchmarks/make_experiments_md.py``.  Sources (the
single sources of truth): ``BENCH_torch_sssp.json``,
``BENCH_torch_serve.json``, ``BENCH_torch_dynamic.json``,
``BENCH_torch_tune.json`` and the paper-table CSVs under
experiments/bench_torch/ (``weak_scaling.csv`` as in JAX, and Tables II-IV
and Figs. 2/3).  Hand-written text outside the marker comments stays.  It
never writes the JAX package's EXPERIMENTS.md.

Each table's heading line names torch, the device and its power limit from
the record's ``meta`` (a CSV's from its ``<stem>.meta.json``); the rows are
the JAX package's.  The dry-run and roofline sections read the dry-run
records under experiments/dryrun_torch/ (``python -m
repro_torch.launch.dryrun --all --mesh both``); their first line says
they are H100 predictions from data-sheet peaks, not card readings.

    PYTHONPATH=src python -m repro_torch.benchmarks.make_experiments_md
"""
from __future__ import annotations

import csv
import json
import os

from repro_torch.benchmarks import common, roofline

REPO = str(common.REPO)
BENCH_JSON = os.path.join(REPO, "BENCH_torch_sssp.json")
SERVE_JSON = os.path.join(REPO, "BENCH_torch_serve.json")
DYNAMIC_JSON = os.path.join(REPO, "BENCH_torch_dynamic.json")
TUNE_JSON = os.path.join(REPO, "BENCH_torch_tune.json")
MD = os.path.join(REPO, "EXPERIMENTS_torch.md")
#: the paper-table CSVs (under common.OUT_DIR) by section, with the caption
#: of each table
CSV_SECTIONS = (
    ("table2", "table2_sparse_csr.csv",
     "paper Table II: dense matrix vs CSR, `bellman` vs `bellman_csr`."),
    ("table3", "table3_density.csv",
     "paper Table III: dense vs sparse graphs at equal n."),
    ("table4", "table4_scaling.csv",
     "paper Table IV / Fig. 6: strong scaling; efficiency = t(1) / "
     "(P t(P))."),
    ("fig23", "fig23_size_sweep.csv",
     "paper Figs. 2/3: time vs graph size (m = 3n)."),
    ("multisource", "multisource_amortization.csv",
     "multisource batching: time per source vs batch size."),
)
WEAK_CAPTION = "fixed vertices/process; efficiency = t(P=1) / t(P)."

BEGIN = "<!-- BEGIN GENERATED:{} -->"
END = "<!-- END GENERATED:{} -->"
INTRO = ("# EXPERIMENTS — PyTorch / H100 port\n\n"
         "Generated by `python -m repro_torch.benchmarks.make_experiments_md` "
         "from the port's bench records; each table's first line says what "
         "it ran on.  Do not edit inside the markers.\n")


def stamp(meta: dict) -> str:
    """torch, the device and its power limit, from a record's meta."""
    return (f"torch {meta.get('torch', '?')} on "
            f"{meta.get('device_name', 'an unrecorded device')} "
            f"({meta.get('device', '?')}, power limit "
            f"{meta.get('power_limit') or 'n/a'})")


def dryrun_table(recs) -> str:
    """The dry-run records -> one device's memory and collectives a
    cell."""
    rows = [roofline.caption(recs), "",
            "| arch | shape | mesh | chips | trace_s | GB/dev | fits 80 GB "
            "| all-gather GB | all-reduce GB | reduce-scatter GB | a2a GB "
            "| cperm GB |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        m = r["memory_analysis"]
        w = r["weighted"]["collective_bytes"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['chips']} "
            f"| {r['trace_s']:.1f} | {m['live_bytes_per_device'] / 1e9:.1f} "
            f"| {'yes' if m['fits'] else 'NO'} "
            f"| {w['all-gather'] / 1e9:.2f} | {w['all-reduce'] / 1e9:.2f} "
            f"| {w['reduce-scatter'] / 1e9:.2f} "
            f"| {w['all-to-all'] / 1e9:.2f} "
            f"| {w['collective-permute'] / 1e9:.2f} |")
    return "\n".join(rows)


def roofline_table(recs) -> str:
    """The dry-run records -> every roofline term a cell (seconds a
    step on one H100), the dominant one, one device's memory, the
    MODEL_FLOPS ratio and MFU (``benchmarks/roofline.py``'s table)."""
    return "\n".join([roofline.caption(recs), "", roofline.HEADER]
                     + [roofline.fmt_row(r) for r in recs])


def bench_tables(path: str) -> str:
    """BENCH_torch_sssp.json (benchmarks/run_bench.py) -> per-point engine table
    plus the edges-relaxed gate summary."""
    with open(path) as f:
        doc = json.load(f)
    meta = doc["meta"]
    rows = [f"{stamp(meta)}"
            f"{' (smoke)' if meta.get('smoke') else ''}, "
            f"best of {meta['repeats']}; times are per source; sharded "
            f"engines run on {meta.get('devices', 1)} rank(s) of one group.",
            "",
            "| corpus | n | m | engine | P | time_s/src | sweeps "
            "| edges relaxed |",
            "|---|---|---|---|---|---|---|---|"]
    for r in doc["results"]:
        er = r["edges_relaxed"]
        rows.append(
            f"| {r['corpus']} | {r['n']} | {r['m']} | {r['engine']} "
            f"| {r.get('procs', 1)} "
            f"| {r['time_s'] / r['sources']:.5f} | {r['sweeps'] or ''} "
            f"| {'' if er is None else er} |")
    gate = doc["gate"]
    rows += ["", f"**Gate** ({gate['rule']}): "
                 f"{'PASS' if gate['pass'] else 'FAIL'}",
             "",
             "| n | frontier edges | bellman_csr edges | ratio |",
             "|---|---|---|---|"]
    for p in gate["points"]:
        rows.append(f"| {p['n']} | {p['frontier_edges']} "
                    f"| {p['bellman_csr_edges']} | {p['edge_ratio']} |")
    gs = doc.get("gate_sharded")
    if gs:
        rows += ["", f"**Gate** ({gs['rule']}): "
                     f"{'PASS' if gs['pass'] else 'FAIL'}",
                 "",
                 "| n | P | frontier_sharded edges | frontier edges |",
                 "|---|---|---|---|"]
        for p in gs["points"]:
            rows.append(f"| {p['n']} | {p['procs']} "
                        f"| {p['frontier_sharded_edges']} "
                        f"| {p['frontier_edges']} |")
    gd = doc.get("gate_delta")
    if gd:
        rows += ["", f"**Gate** ({gd['rule']}): "
                     f"{'PASS' if gd['pass'] else 'FAIL'}",
                 "",
                 "| corpus | n | Δ phases | frontier sweeps "
                 "| Δ time_s | frontier time_s |",
                 "|---|---|---|---|---|---|"]
        for p in gd["points"]:
            rows.append(f"| {p['corpus']} | {p['n']} | {p['delta_phases']} "
                        f"| {p['frontier_sweeps']} | {p['delta_time_s']} "
                        f"| {p['frontier_time_s']} |")
    return "\n".join(rows)


def serve_table(path: str) -> str:
    """BENCH_torch_serve.json (benchmarks/serve_bench.py) -> per-scenario
    serving table plus the throughput/cache gate summary."""
    with open(path) as f:
        doc = json.load(f)
    meta = doc["meta"]
    rows = [f"{stamp(meta)}"
            f"{' (smoke)' if meta.get('smoke') else ''}; closed-loop "
            f"drains, {meta['max_batch']} max distinct sources/tick, "
            f"{meta['landmarks']} landmarks, {meta['cache_rows']}-row "
            "cache; cold = first trace, steady = second trace over the "
            "same Zipf hot set; sequential = one fresh frontier solve "
            "per query.",
            "",
            "| scenario | n | queries | cold q/s | steady q/s "
            "| sequential q/s | steady speedup | steady hit rate "
            "| occupancy | dedup saved |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in doc["results"]:
        rows.append(
            f"| {r['scenario']} | {r['n']} | {r['queries_per_trace']} "
            f"| {r['batched_cold_qps']} | {r['batched_steady_qps']} "
            f"| {r['sequential_qps']} | {r['speedup_steady']}x "
            f"| {r['steady_cache_hit_rate']} | {r['mean_occupancy']} "
            f"| {r['dedup_saved']} |")
    gate = doc["gate"]
    rows += ["", f"**Gate** ({gate['rule']}): "
                 f"{'PASS' if gate['pass'] else 'FAIL'} — zipf steady "
                 f"speedup {gate['zipf_speedup_steady']}x (min "
                 f"{gate['min_ratio']}x), steady cache hit rate "
                 f"{gate['zipf_steady_cache_hit_rate']}"]
    srecs = doc.get("sharded_results")
    if srecs:
        rows += ["",
                 "Sharded route (serve/dispatch.py, --devices leg): the "
                 "same Zipf replay through the vertex-partitioned engines "
                 "vs the single-device serve stack on the same graph.",
                 "",
                 "| scenario | n | P | cold q/s | steady q/s "
                 "| single-device steady q/s | speedup | hit rate "
                 "| edges/solve | frontier edges/solve |",
                 "|---|---|---|---|---|---|---|---|---|---|"]
        for r in srecs:
            rows.append(
                f"| {r['scenario']} | {r['n']} | {r['devices']} "
                f"| {r['sharded_cold_qps']} | {r['sharded_steady_qps']} "
                f"| {r['single_steady_qps']} "
                f"| {r['speedup_vs_single_steady']}x "
                f"| {r['steady_cache_hit_rate']} "
                f"| {r['sharded_edges_per_solve']} "
                f"| {r['frontier_edges_per_solve']} |")
        gs = doc["gate_sharded"]
        rows += ["", f"**Gate** ({gs['rule']}): "
                     f"{'PASS' if gs['pass'] else 'FAIL'} — speedup "
                     f"{gs['speedup_vs_single_steady']}x"
                     f"{' (enforced)' if gs['ratio_enforced'] else ''}, "
                     f"edges ratio {gs['edges_ratio']}"]
    orecs = doc.get("overload_results")
    if orecs:
        rows += ["",
                 "Degraded mode (README.md §Robustness, --overload leg): "
                 "the same p2p workload offered OPEN-LOOP at 2x the "
                 "measured sustainable rate, unprotected scheduler vs "
                 "protected (bounded queue + per-query deadlines + "
                 "landmark degradation).",
                 "",
                 "| n | deadline | sustainable q/s | offered q/s "
                 "| unprotected p99 | protected p99 (served) | served ok "
                 "| degraded | rejected/shed/expired |",
                 "|---|---|---|---|---|---|---|---|---|"]
        for r in orecs:
            shed = (r["rejected_at_submit"] + r["shed"]
                    + r["deadline_expired"])
            rows.append(
                f"| {r['n']} | {r['deadline_s']}s "
                f"| {r['sustainable_qps']} | {r['offered_qps']} "
                f"| {round(r['unprotected_p99_s'] * 1e3, 1)} ms "
                f"| {round(r['protected_p99_served_s'] * 1e3, 1)} ms "
                f"| {r['served_ok']} | {r['served_degraded']} "
                f"| {shed} |")
        og = doc["gate_overload"]
        rows += ["", f"**Gate** ({og['rule']}): "
                     f"{'PASS' if og['pass'] else 'FAIL'} — protected "
                     f"p99 {round(og['protected_p99_served_s'] * 1e3, 1)} "
                     f"ms (bound {round(og['p99_bound_s'] * 1e3, 1)} ms), "
                     f"{og['shed_total']} shed + {og['degraded']} "
                     f"degraded"]
    brecs = doc.get("obs_results")
    if brecs:
        rows += ["",
                 "Observability overhead (README.md §Observability, --obs "
                 "leg): two identically-warmed serving stacks drain the "
                 "same steady Zipf traces, tracing disabled vs a live "
                 "Tracer + CostLog installed (repro/obs).",
                 "",
                 "| n | queries | reps | tracing off q/s | tracing on q/s "
                 "| ratio | spans | cost records |",
                 "|---|---|---|---|---|---|---|---|"]
        for r in brecs:
            rows.append(
                f"| {r['n']} | {r['queries_per_trace']} | {r['reps']} "
                f"| {r['tracing_off_qps']} | {r['tracing_on_qps']} "
                f"| {r['tracing_ratio']} | {r['spans']} "
                f"| {r['cost_records']} |")
        bg = doc["gate_obs"]
        rows += ["", f"**Gate** ({bg['rule']}): "
                     f"{'PASS' if bg['pass'] else 'FAIL'} — ratio "
                     f"{bg['tracing_ratio']} (min {bg['min_ratio']})"]
    return "\n".join(rows)


def dynamic_table(path: str) -> str:
    """BENCH_torch_dynamic.json (benchmarks/dynamic_bench.py) -> per-batch-size
    repair-vs-resolve table plus the gate summary."""
    with open(path) as f:
        doc = json.load(f)
    meta = doc["meta"]
    rows = [f"{stamp(meta)}"
            f"{' (smoke)' if meta.get('smoke') else ''}; medians over "
            f"{meta['rounds']} chained mutation rounds per batch size "
            "(each round bitwise-verified against a full re-solve on the "
            "mutated graph); full = cold frontier solve on the same "
            "committed overlay operands.",
            "",
            "| n | m | batch edges | repair ms | full ms | speedup "
            "| repair edges | full edges | edge ratio | cone |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in doc["results"]:
        rows.append(
            f"| {r['n']} | {r['m']} | {r['batch_edges']} "
            f"| {r['repair_time_s'] * 1e3:.2f} | {r['full_time_s'] * 1e3:.2f} "
            f"| {r['speedup']}x | {r['repair_edges']} | {r['full_edges']} "
            f"| {r['edge_ratio']} | {r['cone_median']} |")
    gate = doc["gate"]
    rows += ["", f"**Gate** ({gate['rule']}): "
                 f"{'PASS' if gate['pass'] else 'FAIL'}"]
    return "\n".join(rows)


def tune_table(path: str) -> str:
    """BENCH_torch_tune.json (benchmarks/tune_bench.py) -> per-leg race of the
    measured-model policy against the hard-coded thresholds plus the
    gate_tune summary."""
    with open(path) as f:
        doc = json.load(f)
    meta = doc["meta"]
    cov = meta.get("model_coverage", {})
    rows = [f"{stamp(meta)}"
            f"{' (smoke)' if meta.get('smoke') else ''}, best of "
            f"{meta['repeats']}; model fitted from "
            f"`{os.path.basename(meta['calibration'])}` "
            f"({cov.get('records', '?')} calibrated points over "
            f"{len(cov.get('engines', []))} engine groups); every leg "
            "solves `engine=\"auto\"` under each policy and the answers "
            "are bitwise-compared.",
            "",
            "| corpus | n | P | threshold engine | ms | model engine "
            "| ms | via | ratio |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in doc["results"]:
        rows.append(
            f"| {r['corpus']} | {r['n']} | {r['nprocs']} "
            f"| {r['base']['engine']} | {r['base']['wall_s'] * 1e3:.2f} "
            f"| {r['tuned']['engine']} | {r['tuned']['wall_s'] * 1e3:.2f} "
            f"| {r['tuned']['via']} | {r['ratio']} |")
    gate = doc["gate_tune"]
    rows += ["", f"**Gate** ({gate['rule']}): "
                 f"{'PASS' if gate['pass'] else 'FAIL'}"]
    return "\n".join(rows)


def csv_table(path: str, caption: str) -> str:
    """A paper-table CSV -> a markdown table under one heading line: what
    it ran on (its ``<stem>.meta.json``: torch, the device and its power
    limit, and the device of each timed column) and ``caption``."""
    meta_path = os.path.splitext(path)[0] + ".meta.json"
    head = "run not recorded"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        cols = ", ".join(f"{c} on {d}"
                         for c, d in meta.get("columns", {}).items())
        head = stamp(meta) + (f"; {cols}" if cols else "")
    with open(path) as f:
        rd = list(csv.reader(f))
    rows = [f"{head}; {caption}",
            "",
            "| " + " | ".join(rd[0]) + " |",
            "|" + "---|" * len(rd[0])]
    for r in rd[1:]:
        rows.append("| " + " | ".join(r) + " |")
    return "\n".join(rows)


def weak_scaling_table(path: str) -> str:
    """experiments/bench_torch/weak_scaling.csv (benchmarks/weak_scaling.py)
    -> fixed-n/proc scaling table: dense column slabs vs the vertex-
    partitioned CSR engines (the paper's footnote-7 experiment, the CSR
    leg at 8x the per-process vertex count since no dense matrix exists
    on that path)."""
    return csv_table(path, WEAK_CAPTION)


def splice(text: str, name: str, content: str) -> str:
    b, e = BEGIN.format(name), END.format(name)
    if b in text:
        pre, rest = text.split(b, 1)
        _, post = rest.split(e, 1)
        return pre + b + "\n" + content + "\n" + e + post
    return text + f"\n{b}\n{content}\n{e}\n"


def main() -> str:
    """Splice every table whose source exists into ``MD``; returns its
    path."""
    text = open(MD).read() if os.path.exists(MD) else INTRO
    done = []
    recs = roofline.load_records()
    if recs:
        text = splice(text, "dryrun", dryrun_table(recs))
        text = splice(text, "roofline", roofline_table(recs))
        done += ["dryrun", "roofline"]
    for name, path, table in (
            ("sssp-bench", BENCH_JSON, bench_tables),
            ("serve-bench", SERVE_JSON, serve_table),
            ("dynamic-bench", DYNAMIC_JSON, dynamic_table),
            ("tune-bench", TUNE_JSON, tune_table),
            ("weak-scaling",
             os.path.join(common.OUT_DIR, "weak_scaling.csv"),
             weak_scaling_table)):
        if os.path.exists(path):
            text = splice(text, name, table(path))
            done.append(name)
    for name, csv_name, caption in CSV_SECTIONS:
        path = os.path.join(common.OUT_DIR, csv_name)
        if os.path.exists(path):
            text = splice(text, name, csv_table(path, caption))
            done.append(name)
    with open(MD, "w") as f:
        f.write(text)
    print(f"wrote {', '.join(done) or 'no'} tables into {MD}")
    return MD


if __name__ == "__main__":
    main()
