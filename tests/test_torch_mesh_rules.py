"""The port's sharding rules (repro_torch.sharding.rules) against the JAX
package's, on abstract meshes.

Bounds, fixed before measuring: every spec equal to JAX's, exactly.

- parameters: every leaf of all ten archs' full configs (JAX's
  ``jax.eval_shape(T.init_params)`` against the port's meta-device tree),
  the port's per-layer specs being JAX's stacked specs with the rep entry
  dropped, and ``param_shardings`` of the port's tree in JAX's layout;
- caches at decode_32k and long_500k, with ``REPRO_NO_CACHE_SEQ_FALLBACK``
  set and unset; batches; every ``_ACT_RULES`` rule on shapes that divide
  and shapes that do not;
- meshes (16, 16), (2, 16, 16), (2, 4), (2, 2), (8, 1) and (1, 8);
- JAX's four rules tests (``tests/test_train_substrate.py``) as cases;
- ``placements`` of a spec, ``constrain`` the identity off a device mesh,
  and the ``aten.mm.dtype`` / ``bmm.dtype`` strategies on meta tensors
  over a gloo mesh of two ranks.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, SHAPES, get_config
from repro.core._compat import abstract_mesh
from repro.models import transformer as JT
from repro.sharding import rules as jrules
from repro_torch.configs import get_config as pget_config
from repro_torch.core._dist import spawn
from repro_torch.models import transformer as PT
from repro_torch.models.convert import to_jax_layout
from repro_torch.models.tree import leaves_with_path
from repro_torch.sharding import rules
from repro_torch.sharding.rules import AbstractMesh, Spec

MESHES = [(16, 16), (2, 16, 16), (2, 4), (2, 2), (8, 1), (1, 8)]


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _meshes(shape):
    return (abstract_mesh(shape, _names(shape)),
            AbstractMesh(shape, _names(shape)))


def _key(k):
    return getattr(k, "key", getattr(k, "idx", None))


def _jax_leaves(tree):
    return {tuple(_key(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jspec(sharding_or_spec):
    spec = getattr(sharding_or_spec, "spec", sharding_or_spec)
    return Spec(*tuple(spec))


@pytest.fixture(scope="module")
def jax_params():
    return {a: jax.eval_shape(
        lambda a=a: JT.init_params(jax.random.PRNGKey(0), get_config(a)))
        for a in ARCHS}


@pytest.fixture(scope="module")
def port_params():
    return {a: PT.init_params(pget_config(a), device="meta") for a in ARCHS}


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, shape, jax_params, port_params):
    jm, pm = _meshes(shape)
    jtree = jax_params[arch]
    jspecs = _jax_leaves(jrules.param_shardings(jtree, jm))
    jshapes = _jax_leaves(jtree)
    cfg = pget_config(arch)
    ptree = port_params[arch]
    pspecs = dict(leaves_with_path(
        rules.port_param_specs(ptree, cfg, pm),
        is_leaf=lambda x: isinstance(x, Spec)))
    n = 0
    for path, leaf in leaves_with_path(ptree):
        jpath, rep = rules._jax_param_path(path, cfg)
        want = _jspec(jspecs[jpath])
        got = pspecs[path]
        if rep:
            assert tuple(jshapes[jpath].shape) == (rep,) + tuple(leaf.shape)
            assert want[0] is None
            want = Spec(*want[1:])
        else:
            assert tuple(jshapes[jpath].shape) == tuple(leaf.shape)
        assert got == want, (jpath, got, want)
        n += 1
    assert n >= len(jspecs)
    # the same rules on the port's tree restacked into JAX's layout
    stacked = to_jax_layout(ptree, cfg)
    for path, spec in leaves_with_path(
            rules.param_shardings(stacked, pm),
            is_leaf=lambda x: isinstance(x, Spec)):
        jpath = tuple(k for _, k in path)
        assert spec == _jspec(jspecs[jpath]), jpath


@pytest.mark.parametrize("fallback", ["on", "off"])
@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, shape, fallback, monkeypatch):
    if fallback == "off":
        monkeypatch.setenv("REPRO_NO_CACHE_SEQ_FALLBACK", "1")
    else:
        monkeypatch.delenv("REPRO_NO_CACHE_SEQ_FALLBACK", raising=False)
    jm, pm = _meshes(shape)
    jcfg, pcfg = get_config(arch), pget_config(arch)
    for shp in ("decode_32k", "long_500k"):
        B, S = SHAPES[shp].global_batch, SHAPES[shp].seq_len
        jc = jax.eval_shape(lambda: JT.init_cache(jcfg, B, S))
        jspecs = _jax_leaves(jrules.cache_shardings(jc, jm))
        jshapes = _jax_leaves(jc)
        pc = PT.init_cache(pcfg, B, S, device="meta")
        got = dict(leaves_with_path(rules.port_cache_specs(pc, pm),
                                    is_leaf=lambda x: isinstance(x, Spec)))
        for path, leaf in leaves_with_path(pc):
            (jpath, rep) = rules._jax_param_path(
                (("key", "layers"),) + path, pcfg)
            jpath = jpath[1:]
            assert tuple(jshapes[jpath].shape) == (rep,) + tuple(leaf.shape)
            want = _jspec(jspecs[jpath])
            assert want[0] is None
            assert got[path] == Spec(*want[1:]), (shp, jpath)
            # the JAX-layout function itself on the stacked shape
            assert rules.cache_spec(jshapes[jpath].shape, pm) == want


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_batch_and_activation_specs_equal_jax(shape):
    jm, pm = _meshes(shape)
    shapes = [(256, 4096), (1, 524288), (128, 1), (7, 3), (32, 1024, 2048),
              (6, 8)]
    for s in shapes:
        assert rules.batch_spec(s, pm) == _jspec(jrules.batch_spec(s, jm))
    assert rules._ACT_RULES == jrules._ACT_RULES
    assert rules._PARAM_RULES == jrules._PARAM_RULES
    dims = (1, 2, 3, 4, 6, 8, 16, 60, 64, 256, 2048)
    rng = np.random.default_rng(0)
    for rule, prefs in rules._ACT_RULES.items():
        for _ in range(12):
            s = tuple(int(d) for d in rng.choice(dims, len(prefs)))
            assert rules.assign_spec(s, prefs, pm) == _jspec(
                jrules.assign_spec(s, prefs, jm)), (rule, s)


# JAX's four rules tests, as the port runs them

def test_assign_spec_divisibility_fallback():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    assert rules.assign_spec((8, 16), [["dp"], ["tp"]], mesh) == Spec(
        "data", "model")
    assert rules.assign_spec((7, 16), [["dp"], ["tp"]], mesh) == Spec(
        None, "model")
    assert rules.assign_spec((8, 8), [["tp"], ["tp"]], mesh) == Spec(
        "model", None)


def test_param_rules_moe_fallback():
    mesh = AbstractMesh((2, 16), ("data", "model"))
    path = ("segments", 0, 0, "ffn", "wi_gate")
    assert rules.spec_for_param(path, (24, 60, 64, 1408), mesh) == Spec(
        None, None, "data", "model")
    assert rules.spec_for_param(path, (24, 64, 64, 1408), mesh) == Spec(
        None, "model", "data", None)


def test_cache_spec_long_context_batch1():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    assert rules.cache_spec((26, 1, 1024, 4, 256), mesh) == Spec(
        None, None, "data", "model", None)
    assert rules.cache_spec((26, 128, 1024, 4, 256), mesh) == Spec(
        None, "data", None, "model", None)


def test_constrain_noop_outside_mesh():
    x = torch.ones((4, 8, 16))
    assert rules.constrain(x, "hidden") is x
    assert rules.dp_size() == 1 and rules.tp_size() == 1
    with rules.set_mesh(AbstractMesh((2, 4), ("data", "model"))):
        # an abstract mesh sizes the axes and moves no tensor
        assert rules.constrain(x, "hidden") is x
        assert rules.dp_size() == 2 and rules.tp_size() == 4
    assert rules.get_mesh() is None


def test_spec_equality_is_partition_specs():
    from jax.sharding import PartitionSpec as P
    cases = [(("data", None), ("data",)), ((("data",),), ("data",)),
             ((("pod", "data"), None), (("pod", "data"), None)), ((), (None,))]
    for a, b in cases:
        assert (Spec(*a) == Spec(*b)) == (P(*a) == P(*b)), (a, b)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    m = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert rules.placements(Spec(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert rules.placements(Spec(None, "data"), m) == (
        Replicate(), Shard(1), Replicate())
    assert rules.placements(Spec(), m) == (Replicate(),) * 3
    # an axis of one device: replicated, the same layout
    one = AbstractMesh((1, 2), ("data", "model"))
    assert rules.placements(Spec("data", "model"), one) == (
        Replicate(), Shard(1))


def _mm_dtype_rank(group):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
    rules.register_strategies()
    out = []

    def dt(shape, pl):
        return DTensor.from_local(torch.empty(shape, dtype=torch.bfloat16,
                                              device="meta"), mesh, (pl,),
                                  run_check=False)
    for pa, pb, sa, sb in ((Shard(0), Replicate(), (4, 6), (6, 8)),
                           (Replicate(), Shard(1), (4, 6), (6, 8)),
                           (Shard(1), Shard(0), (4, 3), (3, 8))):
        o = torch.mm(dt(sa, pa), dt(sb, pb), out_dtype=torch.float32)
        out.append((repr(o.placements[0]), tuple(o.shape), str(o.dtype)))
    o = torch.bmm(dt((2, 4, 6), Shard(0)), dt((2, 6, 8), Shard(0)),
                  out_dtype=torch.float32)
    out.append((repr(o.placements[0]), tuple(o.shape), str(o.dtype)))
    return out


def test_mm_dtype_strategies_on_dtensors(tmp_path):
    """The bf16 product with an f32 result (``models.common._Bf16DotF32``)
    has DTensor strategies equal to mm's / bmm's: the output layout of
    each input layout.  Its local kernel exists on CUDA and meta only,
    so the locals here are meta tensors."""
    got = spawn(_mm_dtype_rank, 2, backend="gloo", store_dir=tmp_path)[0]
    assert got == [("Shard(dim=0)", (8, 8), "torch.float32"),
                   ("Shard(dim=1)", (4, 16), "torch.float32"),
                   ("Partial(sum)", (4, 8), "torch.float32"),
                   ("Shard(dim=0)", (4, 4, 8), "torch.float32")]
