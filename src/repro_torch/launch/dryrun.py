"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): trace every
(architecture x input shape x mesh) cell on the production mesh with fake
tensors (no allocation, no card) and record one device's memory, costs,
collectives and H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both [--jobs 7]

Where JAX lowers and compiles the step against 512 forced host devices,
the port starts a fake process group of the mesh's size (256 ranks a pod,
512 for two) in this one process, builds a ``DeviceMesh`` with the
mesh's axis names over it, turns ``launch.specs.build_cell``'s meta
stand-ins into fake DTensors laid out by the cell's specs, and runs the
step once under ``launch.cost_analysis``'s counter as rank 0 (JAX's
``--save-hlo`` and ``XLA_FLAGS`` have no counterpart).  Each cell writes
``<out>/<arch>__<shape>__<mesh><tag>.json`` with JAX's keys
(``memory_analysis``, ``weighted``, ``roofline``, ``mfu_fraction``,
``meta``, ``overrides``; ``trace_s`` where JAX has ``lower_s`` /
``compile_s``), torch's version and the roofline's constants.  Every
number in a record is a prediction from data-sheet peaks, not a reading
of a card.

Each rank's blocks are fake meta tensors, on any torch build (one built
for the CPU alone cannot record autograd on a fake CUDA tensor), and the
mesh is a CUDA one.  The models take the card's op path on meta tensors
(``models.common.dot_f32``), so the trace counts the card's ops;
chip_smoke.py holds a meta trace's counts to those over real CUDA
tensors on the card.

SSSP cells (the paper's engines at production scale) stand beside the
LM cells: ``--arch sssp --shape bellman_512k | dijkstra_128k |
multisource_128k``, on a ``ShardGroup`` over the fake group, each rank's
adjacency block a fake tensor.  A fixpoint's sweep is traced once and
weighted 1 (JAX's ``while_loop`` has no known trip count); Alg. 2's
iteration is traced once and weighted ``n_true``, its ``fori_loop``'s
trip count.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, LONG_CONTEXT_ARCHS, SHAPES
from repro_torch.launch import cost_analysis as C
from repro_torch.launch.mesh import make_production_mesh

SSSP_SHAPES = ("bellman_512k", "dijkstra_128k", "multisource_128k")
DEFAULT_OUT = os.path.join("experiments", "dryrun_torch")


#: the device of the fake tensors: meta (module doc)
TRACE_DEVICE = "meta"


@contextlib.contextmanager
def fake_world(mesh, device_type: str):
    """A fake process group of ``mesh``'s size (this process is rank 0;
    no collective moves data) and a ``DeviceMesh`` over it with the
    mesh's axis names.  Torn down on exit, so a process may open one
    after another."""
    import torch.distributed as dist
    # registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    from torch.distributed.device_mesh import DeviceMesh

    if dist.is_initialized():
        raise RuntimeError("this process already holds a process group")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=mesh.size)
    try:
        ranks = torch.arange(mesh.size).reshape(mesh.axis_shape)
        yield DeviceMesh(device_type, ranks, mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()


def _fake_leaf(meta, spec, mesh, device_type: str):
    """A fake DTensor of ``meta``'s global shape and dtype laid out by
    ``spec``: rank 0's block of it, a fake tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import rules
    local = torch.empty(rules.shard_shape(tuple(meta.shape), spec, mesh),
                        dtype=meta.dtype, device=device_type)
    return DTensor.from_local(local, mesh, rules.placements(spec, mesh),
                              run_check=False, shape=meta.shape,
                              stride=meta.stride())


def fake_args(args, specs, mesh, device_type: str):
    """``args`` (a tree of meta stand-ins) as fake DTensors on ``mesh``,
    each laid out by its spec in ``specs`` (a tree of the same shape).
    Call under ``FakeTensorMode``."""
    from repro_torch.models.tree import leaves, unflatten
    from repro_torch.sharding import rules
    spec_leaves = leaves(specs, is_leaf=lambda x: isinstance(x, rules.Spec))
    arg_leaves = leaves(args)
    if len(spec_leaves) != len(arg_leaves):
        raise ValueError(f"{len(arg_leaves)} arguments against "
                         f"{len(spec_leaves)} specs")
    return unflatten(args, [_fake_leaf(a, s, mesh, device_type)
                            for a, s in zip(arg_leaves, spec_leaves)])


def table_gathers(collectives: dict, vocab: int, tp: int) -> list:
    """The all-gathers in ``collectives`` (a counter's
    ``collective_outputs`` named by :func:`by_axis`: kind -> ``"axis:
    (input) -> (output)"`` -> calls) that gather a vocab-split table's
    rows: over "model" (``tp`` ranks), of a 2-D block with ``vocab / tp``
    rows or columns.  What a lookup must not issue (JAX's ``jnp.take``
    gathers each rank's rows locally and sums).  A gather over "data" of
    the same block (its d-split) is not one, though its output has
    ``vocab`` rows when the two axes are of one size (the collective
    gathers along dim 0)."""
    calls = collectives.get("all-gather", {})
    out = []
    for key in calls:
        axis, _, shapes = key.partition(": ")
        block = ast.literal_eval(shapes.split(" -> ")[0])
        if axis == "model" and len(block) == 2 and vocab // tp in block:
            out.append(key)
    return sorted(out)


def _local_bytes(tree) -> int:
    from repro_torch.models.tree import leaves
    return sum(C._nbytes(C._local(t)) for t in leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# SSSP cells
# ---------------------------------------------------------------------------

def build_sssp_cell(shape_name: str, group, device_type: str,
                    overrides: dict | None = None) -> tuple:
    """``(step, meta)`` of one of the three SSSP cells on ``group`` (a
    ``ShardGroup`` over the fake world): ``step(counter)`` runs the
    engine's start, one loop body (weighted by ``meta["weight"]``) and
    its finish on this rank's fake block and returns ``count_step``'s
    stats and memory.  overrides: {"minloc": "pmin"} for Alg. 2's MINLOC,
    {"n": 1024} for a smaller graph."""
    from repro_torch.core import bellman, multisource, sharded

    ov = overrides or {}
    P = group.size
    if shape_name == "bellman_512k":
        n = int(ov.get("n", 524_288))
        meta = {"n": n, "engine": "bellman_sharded", "sweep_cap": 64,
                "loop": "while (fixpoint): one sweep, weight 1"}
        weight = 1

        def body(adj, counter):
            d = bellman.sharded_start(adj, 0)
            with counter.weighted(weight):
                d, _ = bellman.sharded_sweep(d, adj, group)
            return bellman.sharded_finish(d, adj, 0, group)
    elif shape_name == "dijkstra_128k":
        n = int(ov.get("n", 131_072))
        minloc = ov.get("minloc", "allgather")
        meta = {"n": n, "engine": "dijkstra_sharded (paper Alg.2)",
                "minloc": minloc,
                "loop": "fori (n_true): one iteration, weight n_true"}
        weight = n

        def body(adj, counter):
            carry = sharded.dijkstra_start(adj, 0, group)
            with counter.weighted(weight):
                carry = sharded.dijkstra_iteration(carry, adj, group,
                                                   minloc=minloc)
            return sharded.dijkstra_finish(carry, group)
    elif shape_name == "multisource_128k":
        n, s = int(ov.get("n", 131_072)), 64
        meta = {"n": n, "sources": s, "engine": "multisource_sharded",
                "sweep_cap": 64,
                "loop": "while (fixpoint): one sweep, weight 1"}
        weight = 1

        def body(adj, counter):
            srcs = torch.arange(s, dtype=torch.int32, device=adj.device)
            D = multisource.init_dist(n, srcs, adj.dtype)
            with counter.weighted(weight):
                D, _ = multisource.sharded_sweep(D, adj, group)
            return D
    else:
        raise KeyError(shape_name)
    if n % P:
        raise ValueError(f"n = {n} does not split over {P} ranks")

    def step(counter):
        adj = torch.empty((n, n // P), dtype=torch.float32,
                          device=device_type)
        return C.count_step(body, adj, counter, counter=counter)[:2]

    return step, dict(meta, weight=weight, tokens_per_step=0, ranks=P)


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str, *,
             overrides: dict | None = None, tag: str = "",
             mesh=None, op_log: bool = False) -> dict:
    """Trace one cell and write its record; returns the record.  ``mesh``
    (an ``AbstractMesh``) replaces the production mesh of ``mesh_kind``
    (small meshes for tests).  ``op_log`` also writes the counter's op
    log (:class:`cost_analysis.StepCounter`) beside the record, as
    ``<name>.ops.json``.  The record's ``table_gathers`` lists an LM
    cell's all-gathers of its embedding table (:func:`table_gathers`);
    a cell with any raises, after writing its files."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core._dist import ShardGroup
    from repro_torch.sharding import rules

    amesh = mesh or make_production_mesh(multi_pod=mesh_kind == "multipod")
    chips = amesh.size
    mesh_shape = dict(zip(amesh.axis_names, amesh.axis_shape))
    dev_type = TRACE_DEVICE
    overrides = dict(overrides or {})
    rules.register_strategies()
    counter = C.StepCounter(log=op_log)
    t0 = time.time()
    with fake_world(amesh, "cuda") as dmesh, \
            FakeTensorMode(allow_non_fake_inputs=True):
        vocab = None
        if arch == "sssp":
            group = ShardGroup(rank=0, size=chips,
                               device=torch.device(dev_type),
                               backend="fake")
            step, meta = build_sssp_cell(shape_name, group, dev_type,
                                         overrides)
            ws, mem = step(counter)
            model_flops, kind = None, "sssp"
            n = meta["n"]
            parts = {"adjacency_bytes": n * (n // chips) * 4}
        else:
            from repro_torch.launch.specs import build_cell
            ga = overrides.pop("grad_accum", None)
            cell = build_cell(arch, shape_name, dmesh,
                              cfg_overrides=overrides or None,
                              grad_accum=ga)
            cfg, kind, meta = cell.cfg, cell.kind, cell.meta
            vocab = cfg.vocab_size
            args = fake_args(cell.args, cell.in_shardings, dmesh, dev_type)
            toks = meta["tokens_per_step"]
            model_flops = (C.analytic_train_flops(cfg, toks)
                           if kind == "train"
                           else C.analytic_decode_flops(cfg, toks))
            if kind == "train":
                state = args[0]
                parts = {"params_bytes": _local_bytes(state.params),
                         "moments_bytes": _local_bytes(
                             [state.opt_state["mu"], state.opt_state["nu"]])}
            else:
                parts = {"params_bytes": _local_bytes(args[0])}
            with rules.set_mesh(dmesh):
                ws, mem, _ = C.count_step(cell.step_fn, *args,
                                          counter=counter)
        collectives = by_axis(counter.collective_outputs, dmesh)
    trace_s = time.time() - t0
    gathers = ([] if vocab is None else table_gathers(
        collectives, vocab, mesh_shape.get("model", 1)))
    rf = C.roofline(ws, chips=chips, model_flops=model_flops)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": mesh_shape,
        "chips": int(chips), "kind": kind, "meta": meta,
        "trace_s": round(trace_s, 2),
        "memory_analysis": dict(mem, **parts),
        "weighted": ws.to_dict(),
        "roofline": rf.to_dict(),
        "mfu_fraction": C.mfu_fraction(rf, chips),
        "table_gathers": gathers,
        "overrides": overrides,
        "traced": {"torch": torch.__version__, "device": dev_type,
                   "rank": 0},
        "constants": C.CONSTANTS,
        "prediction": "from data-sheet peaks (H100 SXM, 700 W); not a "
                      "reading of a card",
    }
    name = f"{arch}__{shape_name}__{mesh_kind}{tag}".replace("/", "_")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        if op_log:
            with open(os.path.join(out_dir, name + ".ops.json"), "w") as f:
                json.dump({"torch": torch.__version__, "ops": counter.ops,
                           "peak_by_op": counter.peak_by_op,
                           "collective_outputs": collectives}, f)
    if gathers:
        raise RuntimeError(f"{name} all-gathers its embedding table: "
                           f"{gathers}")
    return rec


def by_axis(collectives: dict, dmesh) -> dict:
    """A counter's ``collective_outputs`` with each of ``dmesh``'s groups
    named by its mesh axis (call while the mesh's world is up)."""
    axis_of = {dmesh.get_group(i).group_name: n
               for i, n in enumerate(dmesh.mesh_dim_names)}

    def named(key):
        group, _, rest = key.partition(": ")
        return f"{axis_of.get(group, group)}: {rest}"
    return {kind: {named(k): n for k, n in calls.items()}
            for kind, calls in collectives.items()}


def cells_for(mesh_kind: str):
    for arch in ARCHS:
        for sh in SHAPES:
            if sh == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            yield arch, sh
    for sh in SSSP_SHAPES:
        yield "sssp", sh


#: the shapes' trace times, slowest first (the records' ``trace_s``)
_SHAPE_RANK = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
               "long_500k": 3}


def _slowest_first(cell) -> tuple:
    """Sort key of an (arch, shape, mesh) cell: kimi-k2 first, the SSSP
    cells last, then train > prefill > decode, the multipod first."""
    arch, shape, mesh = cell
    return (arch != "kimi-k2-1t-a32b", arch == "sssp",
            _SHAPE_RANK.get(shape, 4), mesh != "multipod")


def run_children(cells, jobs: int, rest: list) -> int:
    """Trace each (arch, shape, mesh) cell in a child process of its own
    (each with its own fake world), ``jobs`` at a time, the slowest
    first; ``rest`` are the children's other arguments.  Each child's
    output is printed when it ends.  Returns the number that failed."""
    import tempfile

    todo = sorted(cells, key=_slowest_first)
    # fake tensors compute nothing: one thread a child
    env = dict(os.environ, OMP_NUM_THREADS="1")
    running, failures = [], 0
    try:
        while todo or running:
            while todo and len(running) < max(1, jobs):
                arch, shape, mesh = todo.pop(0)
                log = tempfile.TemporaryFile("w+")
                running.append((subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     *rest], stdout=log, stderr=subprocess.STDOUT,
                    env=env), log))
            time.sleep(0.2)
            for proc, log in [r for r in running
                              if r[0].poll() is not None]:
                running.remove((proc, log))
                failures += proc.returncode != 0
                log.seek(0)
                print(log.read(), end="", flush=True)
                log.close()
    finally:
        for proc, log in running:
            proc.kill()
            proc.wait()
            log.close()
    return failures


def _summary(rec: dict) -> str:
    rf = rec["roofline"]
    mfu = rec["mfu_fraction"]
    mfu_s = f" mfu={mfu:.3f}" if mfu is not None else ""
    gb = rec["memory_analysis"]["live_bytes_per_device"] / 1e9
    return (f"[ok] {rec['arch']:24s} {rec['shape']:16s} {rec['mesh']:8s} "
            f"trace={rec['trace_s']:.1f}s dominant={rf['dominant']:10s} "
            f"bound={rf['bound_time_s']:.4f}s live={gb:.1f}GB{mfu_s}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (e.g. moe_impl=ep); "
                         "values parsed as python literals when possible")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    ap.add_argument("--op-log", action="store_true",
                    help="also write each cell's op log (<name>.ops.json)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one child process a cell "
                         "(--all or --mesh both)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, _, v = kv.partition("=")
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    todo = [(a, s, mk) for mk in meshes
            for a, s in (cells_for(mk) if args.all
                         else [(args.arch, args.shape)])]
    if len(todo) > 1:
        rest = ["--out", args.out, "--tag", args.tag] + [
            f"--override={kv}" for kv in args.override] + (
            ["--op-log"] if args.op_log else [])
        failures = run_children(todo, args.jobs, rest)
        print(f"done: {len(todo) - failures}/{len(todo)} cells passed",
              flush=True)
        return 1 if failures else 0
    (arch, sh, mk), = todo
    try:
        rec = run_cell(arch, sh, mk, args.out, overrides=overrides,
                       tag=args.tag, op_log=args.op_log)
    except Exception:                # the boundary: report, exit 1
        print(f"[FAIL] {arch} {sh} {mk}\n{traceback.format_exc()}",
              flush=True)
        return 1
    print(_summary(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
