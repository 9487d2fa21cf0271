"""Does gloo carry CUDA tensors for the collectives a ShardGroup issues?

Spawns P ranks (default 4) that all use one card (``cuda:0``) and join one
gloo group on a file store, then runs, on CUDA tensors, each collective
``repro_torch.core._dist.ShardGroup`` issues: the tiled all-gather, the
all-reduce MIN / MAX / SUM and the broadcast, and checks every result.
Prints one JSON line a collective (``ok``, the error where it failed, and
the mean time of 20 calls at a payload of ``--elems`` float32 a rank) and a
last line with the card's name and power limit.

    python3 tools/gloo_cuda_probe.py [--procs 4] [--elems 1000000]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import tempfile
import time
import traceback


def _rank(rank, size, store, elems, out):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, size), rank=rank,
        world_size=size)
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    rows = []

    def probe(name, fn, check):
        try:
            fn()
            torch.cuda.synchronize()
            ok = bool(check())
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 20 * 1e3
            rows.append({"collective": name, "ok": ok, "ms": ms})
        except Exception as e:            # the finding: record and go on
            rows.append({"collective": name, "ok": False,
                         "error": f"{type(e).__name__}: {e}"[:300]})

    mine = torch.full((elems,), float(rank + 1), device=dev)
    out_g = torch.empty(size * elems, device=dev)
    probe("all_gather_into_tensor", lambda: gather(out_g, mine),
          lambda: torch.equal(out_g.view(size, elems)[:, 0].cpu(),
                              torch.arange(1, size + 1).float()))
    for op, want in (("min", 1.0), ("max", float(size)),
                     ("sum", float(size * (size + 1) // 2))):
        t = torch.empty(elems, device=dev)

        def run(t=t, op=op):
            t.fill_(float(rank + 1))
            dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()))
        probe(f"all_reduce_{op}", run,
              lambda t=t, want=want: bool((t == want).all()))
    b = torch.empty(elems, device=dev)

    def bcast():
        b.fill_(float(rank + 1))
        dist.broadcast(b, 0)
    probe("broadcast", bcast, lambda: bool((b == 1.0).all()))
    dist.destroy_process_group()
    out.put((rank, rows))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--elems", type=int, default=1_000_000)
    args = ap.parse_args()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, daemon=True,
                             args=(r, args.procs, store, args.elems, out))
                 for r in range(args.procs)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in procs:
                r, rows = out.get(timeout=300)
                got[r] = rows
        except Exception:
            traceback.print_exc()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    for row in got.get(0, []):
        row["all_ranks_ok"] = all(
            any(x["collective"] == row["collective"] and x["ok"]
                for x in got[r]) for r in got)
        print(json.dumps(row))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    ok = len(got) == args.procs and all(
        x["ok"] for rows in got.values() for x in rows)
    print(json.dumps({"gloo_carries_cuda": ok, "procs": args.procs,
                      "elems": args.elems}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
