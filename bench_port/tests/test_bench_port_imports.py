"""What the serving process may load, and what the reference may read."""

import ast
import os
import subprocess
import sys

import pytest

from bench_port import serve, spec

BENCH = spec.HERE


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "exllamav2_tpu", raising=False)
    base = set(serve.forbidden_modules())
    monkeypatch.setitem(sys.modules, "exllamav2_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake.sub", object())
    assert set(serve.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "exllamav2_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"exllamav2_tpu", "jax"} <= set(serve.forbidden_modules())


def test_serving_side_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bench_port import serve, weights\n"
            "from exllamav2_tpu_torch.generator.dynamic import "
            "DynamicGenerator\n"
            "from exllamav2_tpu_torch.models import forward\n"
            "print(serve.forbidden_modules())" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=spec.ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(
    BENCH, "reference"))))
def test_reference_imports_nothing_of_the_port(name):
    if not name.endswith(".py"):
        pytest.skip("not a module")
    for mod in _imports(os.path.join(BENCH, "reference", name)):
        top = mod.split(".")[0]
        assert top in ("torch", "math", "importlib", "bench_port",
                       "__future__"), mod
        if top == "bench_port":
            assert mod.startswith("bench_port.reference"), mod


def test_harness_imports_no_jax():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(root, f)):
                    assert mod.split(".")[0] not in serve.FORBIDDEN, (f, mod)


def test_no_result_without_the_port_or_a_card(tmp_path):
    """In a directory holding only BENCHMARK.json and bench_port, a run
    prints no result and exits non-zero."""
    import shutil
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "mistral-7b.stream", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _clear_forbidden(monkeypatch):
    for mod in list(sys.modules):
        if mod.split(".")[0] in serve.FORBIDDEN:
            monkeypatch.delitem(sys.modules, mod)


def test_module_loaded_after_the_window_gives_no_result(monkeypatch):
    """A forbidden module that enters the process after the window, here
    through a metric reader, still stops the run before any result."""
    import types

    from bench_port.tests.tiny import tiny_cell
    _clear_forbidden(monkeypatch)
    real = spec.reader

    def reader(metric):
        fn = real(metric)

        def planted(run):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return fn(run)
        return planted

    monkeypatch.setattr(spec, "reader", reader)
    with pytest.raises(ImportError, match="jax"):
        serve.run_cell("mistral-7b.stream", 2 ** 33 + 5, 4.0, False,
                       device="cpu", cell_spec=tiny_cell("mistral-7b.stream"))


def test_module_loaded_before_printing_gives_no_result(monkeypatch, capsys):
    """run.py looks at sys.modules once more just before it prints."""
    import importlib
    import types

    import torch
    _clear_forbidden(monkeypatch)
    run = importlib.import_module("bench_port.run")

    def run_cell(*a, **k):
        monkeypatch.setitem(sys.modules, "flax.core",
                            types.ModuleType("flax.core"))
        return {"correct": True}

    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, os.environ.get(var, "unset"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(serve, "run_cell", run_cell)
    rc = run.main(["--workload", "mistral-7b.stream", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out.strip() == ""
    assert "flax" in out.err
