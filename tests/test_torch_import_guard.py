"""The port stands alone: repro_torch and chip_smoke.py import neither jax
nor anything of the JAX package (nor ``ml_dtypes``, which only JAX
brings), nor the root ``benchmarks`` package (the port keeps its own bench
helpers), and chip_smoke.py refuses to report a result without a GPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
#: the paper's tables and figures and the SSSP examples
PAPER_MODULES = tuple(
    [f"benchmarks.{m}" for m in ("table2_sparse_csr", "fig23_size_sweep",
                                 "table3_density", "table4_scaling",
                                 "weak_scaling", "run",
                                 "make_experiments_md")]
    + [f"examples.{m}" for m in ("quickstart", "sssp_pipeline",
                                 "sssp_dynamic_demo", "sssp_serve_demo")])
#: the LM configs, the single-device sharding hooks, the models (MoE and
#: Mamba2 included), LM serving and the training substrate
LM_MODULES = (
    ("configs", "configs.base", "configs.gemma2_2b", "sharding.rules")
    + tuple(f"models.{m}" for m in ("common", "mlp", "attention", "blocks",
                                    "transformer", "convert", "moe", "ssm",
                                    "tree"))
    + ("launch.serve", "examples.serve_batch", "data", "data.pipeline",
       "train", "train.optimizer", "train.state", "train.step",
       "train.compression", "checkpoint", "checkpoint.manager",
       "launch.train", "examples.train_lm"))
#: the mesh side: the sharding rules, meshes, cell specs and the memory
#: model
MESH_MODULES = ("sharding.rules", "launch.mesh", "launch.specs",
                "launch.memory_model")
#: the dry run and the roofline
DRYRUN_MODULES = ("launch.cost_analysis", "launch.dryrun",
                  "benchmarks.roofline")
#: the TPU v5e roofline terms of the JAX package's hlo_analysis.py (bf16
#: MXU and f32 VPU FLOP/s, HBM and ICI bytes/s): none is the port's
TPU_CONSTANTS = ("197e12", "3.9e12", "819e9", "50e9/link", "ICI",
                 "v5e")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_leaves_jax_and_repro_out_of_sys_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'benchmarks', 'ml_dtypes'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
        "print(bad)\n"
        "print(sorted(k for k in sys.modules if k.startswith("
        "('repro_torch.examples.', 'repro_torch.benchmarks.'))))\n"
        "print(sorted(k for k in sys.modules if k.startswith("
        "'repro_torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")
    assert int(out[0]) >= 119                  # every module was imported
    assert out[1] == "[]"
    for name in PAPER_MODULES:
        assert f"'repro_torch.{name}'" in out[2], name
    for name in LM_MODULES + MESH_MODULES + DRYRUN_MODULES:
        assert f"'repro_torch.{name}'" in out[3], name


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_file_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for name in PAPER_MODULES + LM_MODULES + MESH_MODULES + DRYRUN_MODULES:
        path = PKG / name.replace(".", "/")
        assert path.with_suffix(".py") in files \
            or path / "__init__.py" in files, name
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro", "benchmarks",
                            "ml_dtypes"}, f


def test_no_tpu_constant_in_the_port():
    for f in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        text = f.read_text()
        for c in TPU_CONSTANTS:
            assert c not in text, (f, c)


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_env() | {"CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_gpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
