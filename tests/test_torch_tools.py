"""Port vs reference: the two tools (perf_qmm, probe_features) on the CPU.

The reference tools never pass `interpret` to `pallas_call` and draw their
inputs inside, so the tests load them from their files, wrap `pallas_call`
(interpret mode on, arguments and outputs recorded), replace perf_qmm's timer
by one call and shrink its shapes. The recorded arguments then go through
the port's plain versions (what its wrappers run on a CPU tensor), and the
two results are compared: int32 partials exactly, f32 sums over groups up to
their order.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from exllamav2_tpu_torch.tools import perf_qmm as T
from exllamav2_tpu_torch.tools import probe_features as PF
from exllamav2_tpu_torch.utils.timing import device_time
from exllamav2_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "ref_" + name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are small: one intra-op thread, so that test workers
    running side by side do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def recorded(monkeypatch):
    """pallas_call in interpret mode; every call appends (args, out)."""
    calls = []
    real = pl.pallas_call

    def pallas_call(kernel, *a, **kw):
        fn = real(kernel, *a, interpret=True, **kw)

        def run(*args):
            out = fn(*args)
            calls.append(([np.asarray(x) for x in args], np.asarray(out)))
            return out
        return run
    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    return calls


def _ref_perf(monkeypatch, shapes, gr=32):
    ref = _load("perf_qmm")
    monkeypatch.setattr(ref, "SHAPES", shapes)
    monkeypatch.setattr(ref, "GR", gr)
    monkeypatch.setattr(ref, "_time", lambda f, x, iters=0: (f(x), 1.0)[1])
    return ref


def _plane(a):
    """uint32 words -> the port's int32 words with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("gr", [32, 128])
@pytest.mark.parametrize("mode,tol", [("bf16", 1e-4), ("int8", 1e-5)])
def test_gp_plain_matches_pallas(recorded, monkeypatch, mode, tol, gr):
    ref = _ref_perf(monkeypatch, [(512, 256)], gr)
    ref.VARIANTS["gp_" + mode]()
    (x, plane, qs, smax), want = recorded[-1]
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16) \
        if mode == "bf16" else torch.from_numpy(x)
    assert xt.dtype == (torch.bfloat16 if mode == "bf16" else torch.int8)
    got = T.gp(xt, _plane(plane), torch.from_numpy(qs),
               torch.from_numpy(smax), bits=4, gr=gr)
    assert got.shape == (8, 256) and want.shape == (8, 256)
    assert _rel(got, want) <= tol


def test_gp_int8_is_the_tools_quantization(recorded, monkeypatch):
    """quantize_x is the reference's clip(round(12 x)) on the same x."""
    ref = _ref_perf(monkeypatch, [(512, 256)])
    ref.VARIANTS["gp_int8"]()
    x = np.asarray(ref._mk_inputs(512, 256)[3])
    xq = T.quantize_x(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(xq, recorded[-1][0][0])


@pytest.mark.parametrize("gr", [32, 128])
@pytest.mark.parametrize("variant", ["nibble_i8", "nibble_i8_k2048"])
def test_nibble_plain_matches_pallas(recorded, monkeypatch, variant, gr):
    ref = _ref_perf(monkeypatch, [(2048, 256)], gr)
    ref.VARIANTS[variant]()
    (xq, x1, plane, qs, smax), want = recorded[-1]
    got = T.nibble_i8(torch.from_numpy(xq), torch.from_numpy(x1),
                      _plane(plane), torch.from_numpy(qs),
                      torch.from_numpy(smax), gr=gr)
    assert _rel(got, want) <= 1e-5
    # x1 is the per-group sum of xq, as the port's helper makes it
    np.testing.assert_array_equal(
        T.group_sums(torch.from_numpy(xq), gr).numpy(), x1)


def test_dma_only_plain_matches_pallas(recorded, monkeypatch):
    """K = 4096 at 4 bits is one full tile of 512 word rows."""
    ref = _ref_perf(monkeypatch, [(4096, 256)])
    ref.VARIANTS["dma_only"]()
    (plane,), want = recorded[-1]
    got = T.dma_only(_plane(plane))
    assert got.shape == (8, 256)
    assert _rel(got, want) <= 1e-6


def test_dma_only_reads_the_ragged_tile_and_returns_the_last_full_one():
    rng = np.random.default_rng(3)
    plane = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (1376, 64),
                                          dtype=np.int64).astype(np.int32))
    tiles = T.dma_only_tiles(plane)
    assert tiles.shape == (3, 64)
    want = plane[1024:].to(torch.float64).sum(0)
    assert (tiles[2].double() - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(T.dma_only(plane), tiles[1].expand(8, 64))
    with pytest.raises(ValueError):
        T.dma_only(plane[:100])


def test_nibble_tiles_follow_the_hints():
    assert T.nibble_tiles(4096, 4096, 132) == (2048, 32)
    assert T.nibble_tiles(11008, 4096, 132) == (5632, 32)
    assert T.nibble_tiles(4096, 256, 132, kt0=4096) == (4096, 32)
    assert T.nibble_tiles(4096, 4096, 132, nt0=4096) == (1536, 64)


def test_unsupported_widths_raise():
    with pytest.raises(NotImplementedError):
        T._check_bits(3)
    x = torch.zeros((8, 512), dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        T.gp(x, torch.zeros((64, 8), dtype=torch.int32),
             torch.ones((512 // 24, 8), dtype=torch.uint8),
             torch.ones((512 // 24, 1)), bits=4, gr=24)


# the reference probes draw with unseeded np.random: seed it, record the
# arguments, and put the same arguments through the port's plain versions
PROBE_NAMES = ["int8_dot", "int8_dot_batched", "u32_to_int8_cast",
               "bitcast_u32_u16", "u16_shift_and", "u8_shift_and",
               "int4_array", "int4_dot", "bf16_dot_bf16_acc_f32",
               "bitcast_u32_i8"]


def test_probe_names_are_the_references():
    assert list(PF.PROBES) == list(_load("probe_features").PROBES) \
        == PROBE_NAMES


@pytest.mark.parametrize("name", PROBE_NAMES)
def test_probe_plain_matches_pallas(recorded, name):
    ref = _load("probe_features")
    np.random.seed(11)
    want_str = ref.PROBES[name]()
    args, want = recorded[-1]
    if name.startswith("int4"):
        # the reference's int4 operand, packed two nibbles a byte
        args[-1] = PF.pack_int4(args[-1].astype(np.int8))
    if name == "bf16_dot_bf16_acc_f32":
        args = [np.asarray(a, np.float32) for a in args]
    probe = PF.PROBES[name]
    tensors = probe.to_torch(*args)
    out = probe.plain(*tensors)
    got = out.numpy()
    if name == "bitcast_u32_u16":
        # the reference writes back the first 256 rows, widened
        np.testing.assert_array_equal(
            got.view(np.uint16)[:256].astype(np.uint32), want)
    elif name == "bf16_dot_bf16_acc_f32":
        assert _rel(got, want) <= PF.BF16_DOT_TOL
    else:
        # unsigned words travel as signed tensors of the same bits
        np.testing.assert_array_equal(got.view(want.dtype), want)
    assert probe.verdict(tensors, out) == want_str
    assert PF.run_probe(name, "cpu") == want_str


def test_int4_pack_roundtrip():
    vals = np.random.default_rng(0).integers(-8, 8, (16, 32)).astype(np.int8)
    got = PF.unpack_int4(torch.from_numpy(PF.pack_int4(vals)))
    np.testing.assert_array_equal(got.numpy(), vals)


def test_device_time_on_a_cpu_tensor_is_a_positive_slope():
    x = torch.randn(256, 256)
    t = device_time(lambda a: a @ a, x, iters=16, reps=3)
    assert 0 < t < 1.0
    with pytest.raises(ValueError):
        device_time(lambda a: a, x, iters=1)


def test_profiling_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("region") as rec:
            torch.ones(8).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
    assert any(e.key == "region" for e in prof.key_averages())
    assert rec.name == "region" and rec.end_ns > rec.start_ns


@pytest.mark.parametrize("tool", ["perf_qmm", "probe_features"])
def test_entry_point_on_the_cpu(tool):
    mod = "exllamav2_tpu_torch.tools." + tool
    r = subprocess.run([sys.executable, "-m", mod, "--device", "cpu"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FAIL" not in r.stdout
    names = T.VARIANTS if tool == "perf_qmm" else PF.PROBES
    assert len(r.stdout.strip().splitlines()) >= len(names)


def test_entry_point_fails_when_a_variant_fails():
    """QMM_BITS=8: the nibble variants raise, the sweep goes on and the
    tool exits non-zero."""
    r = subprocess.run(
        [sys.executable, "-m", "exllamav2_tpu_torch.tools.perf_qmm",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, QMM_BITS="8"))
    assert r.returncode == 1
    assert "nibble_i8 -> FAIL" in r.stdout and "gp_int8:" in r.stdout


@pytest.mark.parametrize("tool", ["perf_qmm", "probe_features"])
def test_entry_point_needs_a_card_unless_told(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run(
        [sys.executable, "-m", "exllamav2_tpu_torch.tools." + tool],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
