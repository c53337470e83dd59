"""The port imports without JAX and imports nothing of the JAX package; its
tokenizer module imports without the `tokenizers` / `sentencepiece`
backends (the card's machine has neither)."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "exllamav2_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "exllamav2_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, bad


def test_import_with_jax_absent():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'tokenizers', 'sentencepiece'):\n"
        "    sys.modules[m] = None\n"
        "import exllamav2_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert {'exllamav2_tpu_torch.vlm', 'exllamav2_tpu_torch.ops.mrope',"
        " 'exllamav2_tpu_torch.vlm.vision_tower'} <= set(names)\n"
        "assert not any(k == 'exllamav2_tpu' or k.startswith('exllamav2_tpu.')"
        " for k in sys.modules), 'JAX package imported'\n"
        "print(len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 39
