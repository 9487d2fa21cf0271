"""Does gloo carry CUDA tensors for the collectives a ShardGroup and
DTensor issue?

Spawns P ranks (default 4) that all use one card (``cuda:0``) and join one
gloo group on a file store, then runs, on CUDA tensors, each collective
``repro_torch.core._dist.ShardGroup`` issues: the tiled all-gather, the
all-reduce MIN / MAX / SUM and the broadcast, and the sum all-reduce and
all-gather of bf16 and f16; prints one JSON line a collective (``ok``,
the error where it failed, and the mean time of 20 calls at a payload of
``--elems`` float32 a rank).  Then each collective DTensor's
redistributions issue (``CASES``: ``reduce_scatter_tensor``,
``all_to_all_single``, the ``torch.distributed._functional_collectives``
forms, and DTensor's redistributions over a 1-D mesh of the ranks, with
and without the port's gather shim, ``core._dist.install_gloo_cuda_gather``)
in a fresh group of P ranks, so a crash ends only its own case: one JSON
line each with the ranks' exit codes (-11: SIGSEGV).  The last lines give
the card's name and power limit and the summary.

    python3 tools/gloo_cuda_probe.py [--procs 4] [--elems 1000000]
"""
from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path


def _rank(rank, size, store, elems, out):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=60))
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
        if rank == 0:                     # progress, in case one hangs
            print("probe " + json.dumps(rows[-1]), flush=True)

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
    tot = float(size * (size + 1) // 2)
    for dt in (torch.bfloat16, torch.float16):
        name = str(dt).removeprefix("torch.")
        t = torch.empty(elems, device=dev, dtype=dt)

        def run(t=t):
            t.fill_(float(rank + 1))
            dist.all_reduce(t)
        probe(f"all_reduce_sum_{name}", run,
              lambda t=t: bool((t.float() == tot).all()))
        g = torch.empty(size * elems, device=dev, dtype=dt)
        m = torch.full((elems,), float(rank + 1), device=dev, dtype=dt)
        probe(f"all_gather_into_tensor_{name}",
              lambda g=g, m=m: gather(g, m),
              lambda g=g: torch.equal(g.view(size, elems)[:, 0].float().cpu(),
                                      torch.arange(1, size + 1).float()))
    dist.destroy_process_group()
    out.put((rank, rows))


#: the collectives DTensor's redistributions issue, each run in a group of
#: its own (a crash in one, as SIGSEGV, ends only that group)
CASES = ("reduce_scatter_tensor", "all_to_all_single", "funcol.all_reduce",
         "funcol.all_gather_tensor", "funcol.all_gather_tensor (cpu tensor)",
         "funcol.reduce_scatter_tensor", "funcol.all_to_all_single",
         "dtensor Partial->Replicate", "dtensor Partial->Shard",
         "dtensor Shard->Replicate", "dtensor Shard(0)->Shard(1)",
         "dtensor Shard->Replicate (port's gather shim)",
         "dtensor Shard(0)->Shard(1) (port's gather shim)")


def _case(rank, size, store, name, elems, out):
    """One case on one rank: (rank, name, ok, error)."""
    import faulthandler

    faulthandler.enable()
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=60))
    group = dist.group.WORLD
    tot = float(size * (size + 1) // 2)
    mine = torch.full((elems,), float(rank + 1), device=dev)
    gathered = torch.arange(1, size + 1).float()
    a2a_in = (torch.arange(size, device=dev, dtype=torch.float32)
              .repeat_interleave(elems) + 100.0 * rank)
    a2a_want = torch.arange(size).float() * 100.0 + rank
    wait = funcol.wait_tensor
    try:
        if "shim" in name:
            sys.path.insert(0, str(Path(__file__).resolve().parents[1]
                                   / "src"))
            from repro_torch.core._dist import install_gloo_cuda_gather
            install_gloo_cuda_gather()
        if name == "reduce_scatter_tensor":
            o = torch.empty(elems, device=dev)
            dist.reduce_scatter_tensor(o, mine.repeat(size))
            ok = bool((o == tot).all())
        elif name == "all_to_all_single":
            o = torch.empty_like(a2a_in)
            dist.all_to_all_single(o, a2a_in)
            ok = torch.equal(o.view(size, elems)[:, 0].cpu(), a2a_want)
        elif name == "funcol.all_reduce":
            ok = bool((wait(funcol.all_reduce(mine, "sum", group))
                       == tot).all())
        elif name.startswith("funcol.all_gather_tensor"):
            x = mine.cpu() if "cpu" in name else mine
            o = wait(funcol.all_gather_tensor(x, 0, group))
            ok = torch.equal(o.view(size, elems)[:, 0].cpu(), gathered)
        elif name == "funcol.reduce_scatter_tensor":
            o = wait(funcol.reduce_scatter_tensor(mine.repeat(size), "sum",
                                                  0, group))
            ok = bool((o == tot).all())
        elif name == "funcol.all_to_all_single":
            o = wait(funcol.all_to_all_single(a2a_in, None, None, group))
            ok = torch.equal(o.view(size, elems)[:, 0].cpu(), a2a_want)
        else:
            from torch.distributed.device_mesh import DeviceMesh
            from torch.distributed.tensor import (DTensor, Partial,
                                                  Replicate, Shard)
            mesh = DeviceMesh("cuda", torch.arange(size),
                              mesh_dim_names=("model",))
            full = torch.arange(size * 8 * 4, device=dev,
                                dtype=torch.float32).reshape(size * 8, 4)
            blk = DTensor.from_local(full[rank * 8:(rank + 1) * 8], mesh,
                                     [Shard(0)], run_check=False)
            part = DTensor.from_local(torch.ones(size * 4, 4, device=dev),
                                      mesh, [Partial()], run_check=False)
            if name.startswith("dtensor Partial->Replicate"):
                ok = bool((part.redistribute(mesh, [Replicate()])
                           .to_local() == size).all())
            elif name.startswith("dtensor Partial->Shard"):
                ok = bool((part.redistribute(mesh, [Shard(0)])
                           .to_local() == size).all())
            elif name.startswith("dtensor Shard->Replicate"):
                ok = torch.equal(blk.redistribute(mesh, [Replicate()])
                                 .to_local(), full)
            else:
                ok = torch.equal(blk.redistribute(mesh, [Shard(1)])
                                 .full_tensor(), full)
        torch.cuda.synchronize()
        out.put((rank, name, bool(ok), None))
    except Exception as e:                # the finding: record and go on
        out.put((rank, name, False, f"{type(e).__name__}: {e}"[:300]))
    dist.destroy_process_group()


def _run_case(ctx, name, size, elems) -> dict:
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_case, daemon=True,
                             args=(r, size, store, name, elems, out))
                 for r in range(size)]
        for p in procs:
            p.start()
        t0 = time.perf_counter()
        for p in procs:
            p.join(timeout=max(1.0, 120 - (time.perf_counter() - t0)))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        got = []
        while not out.empty():
            got.append(out.get())
    codes = [p.exitcode for p in procs]
    ok = len(got) == size and all(g[2] for g in got) and codes == [0] * size
    errors = sorted({g[3] for g in got if g[3]})
    return {"collective": name, "ok": ok, "exitcodes": codes,
            **({"error": errors[0]} if errors else {})}


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
    cases = [_run_case(ctx, name, args.procs, args.elems) for name in CASES]
    for row in cases:
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    ok = len(got) == args.procs and all(
        x["ok"] for rows in got.values() for x in rows)
    print(json.dumps({"gloo_carries_cuda": ok, "procs": args.procs,
                      "elems": args.elems,
                      "dtensor_collectives_failing": [
                          c["collective"] for c in cases if not c["ok"]]}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
