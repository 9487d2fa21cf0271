"""The measurement tools' build of another tree's kernel source
(``kernels/common.build_variant``) and the C-entry binding they share with
the port's own kernels (``kernels/common.c_entry``).  No compiler runs here:
``nvcc`` and the loader are replaced, so these check the command and the
binding, not the kernels."""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro_torch.kernels import common


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    """nvcc and the loader replaced; returns the commands run, and where
    the build directory is."""
    calls = SimpleNamespace(cmds=[], loaded=[], rc=0, log="")

    def run(cmd, **kw):
        calls.cmds.append(cmd)
        return subprocess.CompletedProcess(cmd, calls.rc, stdout=calls.log)

    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(common, "_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(common.subprocess, "run", run)
    monkeypatch.setattr(common.ctypes, "CDLL",
                        lambda path: calls.loaded.append(path) or path)
    return calls


@pytest.mark.parametrize("defines", [(), ("CSR_PULL_LONG_ROW=0xffffffffu",),
                                     ("A=1", "B=2")])
def test_build_variant_compiles_with_the_port_flags_under_its_tag(
        fake_nvcc, defines):
    src = Path("/tree/csrc/relax_matvec.cu")
    lib = common.build_variant(src, "parent", defines)
    out = str(common.BUILD_DIR / "relax_matvec-parent.so")
    assert fake_nvcc.cmds == [["/fake/nvcc", *common.NVCC_FLAGS,
                               *(f"-D{d}" for d in defines),
                               "-o", out, str(src)]]
    assert fake_nvcc.loaded == [out] and lib == out
    assert common.BUILD_DIR.is_dir()


def test_build_variant_raises_with_the_compiler_output(fake_nvcc):
    fake_nvcc.rc, fake_nvcc.log = 1, "error: expected ';'"
    with pytest.raises(RuntimeError, match="expected ';'"):
        common.build_variant(Path("/tree/csrc/ell_relax.cu"), "parent")
    assert fake_nvcc.loaded == []


@pytest.mark.parametrize("entry", ["relax_matvec", "relax_matvec_bf16"])
def test_c_entry_binds_the_launch_symbol(entry):
    fn = SimpleNamespace()
    lib = SimpleNamespace(**{f"{entry}_launch": fn})
    args = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64)
    assert common.c_entry(lib, entry, args) is fn
    assert fn.argtypes == list(args) and fn.restype is ctypes.c_int
