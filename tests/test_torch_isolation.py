"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports jax or any module of the JAX package, and the CUDA entry points
raise without a card instead of running on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these runs are small, and xdist workers running the
# reference suite beside them share the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "src" / "repro_torch"


def _modules():
    for py in sorted(PKG.rglob("*.py")):
        rel = py.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_of_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"mods = {list(_modules())!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or\n"
        "             k.startswith(('jax.', 'jaxlib')) or k == 'repro' or\n"
        "             k.startswith('repro.'))\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20


def test_sources_name_no_jax_or_reference_import():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for py in files:
        tree = ast.parse(py.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (py, n)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs there")
    from repro_torch.kernels import runtime
    from repro_torch.serving.factory import build
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        build("qwen2.5-32b")                          # device defaults to cuda
    with pytest.raises(RuntimeError, match="cuda"):
        from repro_torch.launch import serve
        serve.main(["--requests", "1"])
    assert runtime.resolve_device("cpu").type == "cpu"
