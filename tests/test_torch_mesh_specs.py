"""The port's cell specs and memory model (repro_torch.launch.{specs,
memory_model, mesh}) against the JAX package's, on abstract meshes.

Bounds, fixed before measuring:

- ``build_cell``: for the LM cells (``ARCHS x SHAPES``: 40, of which 34
  run, long_500k only for ``LONG_CONTEXT_ARCHS``) on the pod mesh, and
  the train cells on the multi-pod mesh too, every argument leaf's shape
  and dtype and every in-sharding spec equal to JAX's (a per-layer leaf's
  shape being JAX's stacked shape without the rep, its spec JAX's without
  the rep entry); the train cells' out shardings and ``meta`` equal too;
- ``cell_memory``: ``params_gb``, ``moments_gb``, ``grads_gb``,
  ``cache_gb``, ``activations_gb`` and ``total_gb`` within 1e-12 relative
  of JAX's on the pod and multi-pod meshes, for every cell; the fit judged
  against the H100's 80 GB, never v5e's 16 GB;
- the production meshes' names and shapes equal JAX's; a world of one
  gives the abstract (1, 1) host mesh.
"""
import os

import jax
import pytest

from repro.configs import ARCHS, LONG_CONTEXT_ARCHS, SHAPES
from repro.core._compat import abstract_mesh
from repro.launch import specs as jspecs
from repro_torch.configs import cells
from repro_torch.launch import memory_model as pmm
from repro_torch.launch import specs as pspecs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.tree import leaves_with_path
from repro_torch.sharding import rules
from repro_torch.sharding.rules import Spec

CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if s != "long_500k" or a in LONG_CONTEXT_ARCHS]
MEM_KEYS = ("params_gb", "moments_gb", "grads_gb", "cache_gb",
            "activations_gb", "total_gb")


def _jmesh(multi_pod):
    return (abstract_mesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else abstract_mesh((16, 16), ("data", "model")))


@pytest.fixture(scope="module")
def jmem():
    """JAX's memory model module, imported without leaking its
    ``XLA_FLAGS`` default into this process's later children."""
    old = os.environ.get("XLA_FLAGS")
    import repro.launch.memory_model as m
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return m


def _key(k):
    for a in ("key", "idx", "name"):
        if hasattr(k, a):
            return getattr(k, a)
    raise TypeError(k)


def _jleaves(tree, is_leaf=None):
    return {tuple(_key(k) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _to_jax(path, cfg, cache: bool):
    """(JAX path, rep) of a port path: ``layers`` / ``enc_layers`` entry
    ``j`` (a cache list's index ``j``) -> ``segments`` ``si``, ``i``."""
    keys = [k for _, k in path]
    if cache:
        jp, rep = rules._jax_param_path(["layers"] + keys, cfg)
        return jp[1:], rep
    for n, k in enumerate(keys):
        if k in ("layers", "enc_layers"):
            jp, rep = rules._jax_param_path(keys[n:], cfg)
            return tuple(keys[:n]) + jp, rep
    return tuple(keys), 0


def _same_tree(ptree, pspec, jtree, jspec, cfg, cache=False):
    jl, js = _jleaves(jtree), _jleaves(
        jspec, is_leaf=lambda x: hasattr(x, "spec"))
    specs = dict(leaves_with_path(pspec,
                                  is_leaf=lambda x: isinstance(x, Spec)))
    seen = set()
    for path, leaf in leaves_with_path(ptree):
        jp, rep = _to_jax(path, cfg, cache)
        seen.add(jp)
        want_shape = tuple(jl[jp].shape)
        want_spec = Spec(*tuple(js[jp].spec))
        if rep:
            assert want_shape == (rep,) + tuple(leaf.shape), jp
            assert want_spec[0] is None
            want_spec = Spec(*want_spec[1:])
        else:
            assert want_shape == tuple(leaf.shape), jp
        assert str(leaf.dtype).removeprefix("torch.") == str(jl[jp].dtype), jp
        assert leaf.device.type == "meta"
        got = specs[path]
        if got == Spec() and not want_spec:      # replicated(): P()
            continue
        assert got == want_spec, (jp, got, want_spec)
    assert seen == set(jl), sorted(set(jl) - seen)[:5]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_build_cell_equals_jax(arch, shape):
    jm, pm = _jmesh(False), make_production_mesh()
    jc = jspecs.build_cell(arch, shape, jm)
    pc = pspecs.build_cell(arch, shape, pm)
    assert (pc.kind, pc.meta, pc.cfg.name) == (jc.kind, jc.meta, jc.cfg.name)
    assert len(pc.args) == len(jc.args) == len(pc.in_shardings)
    cfg = pc.cfg
    for i, (pa, ja, ps, js) in enumerate(zip(pc.args, jc.args,
                                             pc.in_shardings,
                                             jc.in_shardings)):
        _same_tree(pa, ps, ja, js, cfg, cache=(pc.kind == "decode"
                                               and i == 3))
    if pc.kind == "train":
        _same_tree(pc.args[0], pc.out_shardings[0], jc.args[0],
                   jc.out_shardings[0], cfg)
        assert pc.out_shardings[1] is None and jc.out_shardings[1] is None
    if pc.kind == "decode":
        _same_tree(pc.args[3], pc.out_shardings[1], jc.args[3],
                   jc.out_shardings[1], cfg, cache=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_train_cell_equals_jax_multipod(arch):
    jc = jspecs.build_cell(arch, "train_4k", _jmesh(True))
    pc = pspecs.build_cell(arch, "train_4k",
                           make_production_mesh(multi_pod=True))
    for pa, ja, ps, js in zip(pc.args, jc.args, pc.in_shardings,
                              jc.in_shardings):
        _same_tree(pa, ps, ja, js, pc.cfg)
    assert (pspecs.default_opt_config(pc.cfg).moment_dtype
            == jspecs.default_opt_config(jc.cfg).moment_dtype)
    assert (pspecs.default_grad_accum(pc.cfg, 256)
            == jspecs.default_grad_accum(jc.cfg, 256))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_memory_equals_jax(arch, shape, multi_pod, jmem):
    want = jmem.cell_memory(arch, shape, _jmesh(multi_pod))
    got = pmm.cell_memory(arch, shape,
                          make_production_mesh(multi_pod=multi_pod))
    for k in MEM_KEYS:
        assert (k in got) == (k in want), k
        if k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
    assert got["fits_card"] == (got["total_gb"] <= 80.0)
    assert "fits_16gb" not in got


def test_memory_model_main_names_the_card(capsys):
    rows = pmm.main(["--mesh", "pod"])
    out = capsys.readouterr().out
    # 40 cells, of which long_500k runs for the four long-context archs
    assert len(rows) == len(CELLS) == 34
    assert len(cells(include_skipped=True)) == 40
    assert "NVIDIA H100 80GB HBM3 80.0 GB" in out
    assert "16 GB" not in out and "v5e" not in out


def test_meshes():
    for multi in (False, True):
        pm = make_production_mesh(multi_pod=multi)
        jm = _jmesh(multi)
        assert pm.axis_names == tuple(jm.axis_names)
        assert pm.shape == dict(jm.shape)
    m = make_host_mesh()
    assert isinstance(m, rules.AbstractMesh)
    assert m.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        make_host_mesh(2, 1)
