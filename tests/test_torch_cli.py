"""The CLI twins (exllamav2_tpu_torch/cli/) against the reference's scripts
(CPU): each twin's main(argv) in process, the reference's script through
runpy with sys.argv set, on the same tiny model directories.

* test_inference: perplexity of a text file within 1e-3, the same -p greedy
  text; -rr reaches the generator (the reference's -rr reduces only the
  model it scores: its -p text is the unreduced model's).
* model_diff and estimate_kld (A = the trained fixture, B = the same with
  numpy-seeded noise on every weight): estimate_kld's numbers within 1e-4
  absolute; model_diff's per-layer MSE and max error within 2e-3 of
  themselves and its KLD within 1e-3 absolute (see MODEL_DIFF_REL); A
  against A gives 0 and 100 % top-1.
* fit_hbm: the same table text for presets and a model directory at an
  explicit --hbm_gib; without a card and without --hbm_gib, an error.
* shard, unshard, convert_safetensors: the same files with the same tensor
  names, and byte-equal tensors after a round trip.
* mmlu (a 4-question csv), humaneval (a 2-problem jsonl), chat (two piped
  turns) and ws_server: the same prompts and picks, completions, replies
  and server settings.
"""

import contextlib
import csv
import io
import json
import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

from exllamav2_tpu_torch.cli import (
    chat, convert_safetensors, estimate_kld, fit_hbm, humaneval, mmlu,
    model_diff, shard, test_inference, unshard, ws_server)
from exllamav2_tpu_torch.convert.standard_cal import STANDARD_CAL_TEXT
from exllamav2_tpu_torch.stloader import STFile, write_safetensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "tests", "fixtures", "trained_tiny")
CPU = ["--device", "cpu"]
# model_diff's printed numbers: the layer-by-layer states of the two packages
# are up to 1.1e-3 of max |state| apart on the trained fixture (it reaches
# 30: bf16 roundings of activations land one ulp apart where f32 sums run in
# another order, as tests/test_torch_archs.py holds whole models), which
# moves a layer's MSE by up to 9.6e-4 of itself and KLD(A||B) by up to 5.7e-4
# over three seeds of tokens (measured)
MODEL_DIFF_REL = 2e-3
MODEL_DIFF_KLD = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(script, argv, monkeypatch, stdin=None) -> str:
    """Run the reference's script as __main__ with sys.argv -> its stdout."""
    buf = io.StringIO()
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [script] + list(argv))
        if stdin is not None:
            m.setattr(sys, "stdin", io.StringIO(stdin))
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(REPO, script), run_name="__main__")
    return buf.getvalue()


def _port(fn, argv, monkeypatch, stdin=None):
    """Run a twin's main(argv) -> (its return value, its stdout)."""
    buf = io.StringIO()
    with monkeypatch.context() as m:
        if stdin is not None:
            m.setattr(sys, "stdin", io.StringIO(stdin))
        with contextlib.redirect_stdout(buf):
            out = fn(list(argv))
    return out, buf.getvalue()


def _after(text, marker) -> float:
    line = next(l for l in text.splitlines() if marker in l)
    return float(line.split(marker)[1].strip().rstrip("%"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    p = tmp_path_factory.mktemp("corpus") / "corpus.txt"
    p.write_text(STANDARD_CAL_TEXT)
    return str(p)


@pytest.fixture(scope="module")
def noisy_dir(tmp_path_factory):
    """The trained fixture with seeded noise (2 % of each tensor's std) on
    every weight: model B of the diff tools."""
    d = tmp_path_factory.mktemp("noisy")
    shutil.copy(os.path.join(TRAINED, "config.json"), d)
    st = STFile(os.path.join(TRAINED, "model.safetensors"))
    rng = np.random.default_rng(21)
    tensors = {}
    for k in st.keys():
        w = st.get_tensor(k).astype(np.float32)
        noise = rng.standard_normal(w.shape).astype(np.float32)
        tensors[k] = (w + 0.02 * w.std() * noise).astype(np.float16)
    st.close()
    write_safetensors(str(d / "model.safetensors"), tensors)
    return str(d)


# ------------------------------------------------------------ test_inference

def test_test_inference_matches_reference(corpus, monkeypatch):
    argv = ["-m", TRAINED, "-l", "512", "-ed", corpus, "-er", "3", "-el",
            "128", "-p", "The quick", "-t", "16", "--greedy"]
    want = _ref("test_inference.py", argv, monkeypatch)
    got, text = _port(test_inference.main, argv + CPU, monkeypatch)
    assert abs(got["perplexity"] - _after(want, "perplexity:")) <= 1e-3
    assert 1.0 < got["perplexity"] < 2.0
    # the -p text: the lines between the cache line and the timing line
    body = want.split(" -- perplexity:")[1].split("\n", 1)[1]
    assert got["text"] == body.split("\n -- 16 tokens in")[0]
    assert got["text"] in text and len(got["text"]) > 0


def _ref_text(out: str) -> str:
    """The -p text of the reference's test_inference output."""
    return out.split("perplexity:")[1].split("\n", 1)[1].split(
        "\n -- 16 tokens in")[0]


def test_test_inference_rank_reduce_reaches_the_generator(corpus,
                                                          monkeypatch):
    base = ["-m", TRAINED, "-l", "512", "-ed", corpus, "-er", "2", "-el",
            "128", "-p", "The quick", "-t", "16", "--greedy"]
    rr = base + ["-rr", "0.1"]
    want, want_rr = (_ref("test_inference.py", a, monkeypatch)
                     for a in (base, rr))
    got, _ = _port(test_inference.main, base + CPU, monkeypatch)
    got_rr, _ = _port(test_inference.main, rr + CPU, monkeypatch)
    # both score the reduced model alike
    assert abs(got_rr["perplexity"] - _after(want_rr, "perplexity:")) \
        <= 1e-3
    assert got_rr["perplexity"] > got["perplexity"] + 0.01
    # the reference's generator ignores -rr; the port's does not
    assert _ref_text(want_rr) == _ref_text(want) == got["text"]
    assert got_rr["text"] != got["text"]


# ------------------------------------------------- model_diff, estimate_kld

def test_model_diff_matches_reference(noisy_dir, monkeypatch):
    argv = ["-ma", TRAINED, "-mb", noisy_dir, "-t", "48"]
    want = _ref("model_diff.py", argv, monkeypatch)
    got, text = _port(model_diff.main, argv + CPU, monkeypatch)
    rows = [l.split() for l in want.splitlines()
            if l.strip() and l.split()[0] in
            ["emb"] + [str(i) for i in range(len(got["layers"]))]]
    assert len(rows) == len(got["layers"]) == 3
    for (name, mse, mx), (rname, rmse, rmx) in zip(got["layers"], rows):
        assert name == rname
        assert abs(mse - float(rmse)) <= MODEL_DIFF_REL * float(rmse)
        assert abs(mx - float(rmx)) <= MODEL_DIFF_REL * float(rmx)
    assert abs(got["kld"] - _after(want, "KLD(A||B):")) <= MODEL_DIFF_KLD
    assert f"{100 * got['top1']:.2f}" == f"{_after(want, 'agreement:'):.2f}"
    assert got["kld"] > 1e-3 and 0.5 < got["top1"] < 1.0
    same, _ = _port(model_diff.main, ["-ma", TRAINED, "-mb", TRAINED, "-t",
                                      "16"] + CPU, monkeypatch)
    assert same["kld"] == 0.0 and same["top1"] == 1.0
    assert all(m == x == 0.0 for _, m, x in same["layers"])


def test_estimate_kld_matches_reference(noisy_dir, monkeypatch):
    argv = ["-ma", TRAINED, "-mb", noisy_dir, "-r", "2", "-l", "96"]
    want = _ref("util/estimate_kld.py", argv, monkeypatch)
    got, _ = _port(estimate_kld.main, argv + CPU, monkeypatch)
    assert abs(got["mean_kld"] - _after(want, "** mean KLD:")) <= 1e-4
    assert abs(got["max_kld"] - _after(want, "** max KLD:")) <= 1e-4
    assert f"{100 * got['top1']:.2f}" == f"{_after(want, 'agreement:'):.2f}"
    same, _ = _port(estimate_kld.main, ["-ma", TRAINED, "-mb", TRAINED, "-r",
                                        "1", "-l", "64"] + CPU, monkeypatch)
    assert same["mean_kld"] <= 1e-6 and same["top1"] == 1.0


# ------------------------------------------------------------------- fit_hbm

@pytest.mark.parametrize("argv", [
    ["--preset", "7b"],
    ["--preset", "70b", "-b", "2.5", "-cq4", "-ctx", "8192", "-tp",
     "1,2,4,8"],
    ["--preset", "34b", "-cfp8", "-hb", "6", "--reserve_gib", "2"],
    ["--preset", "1b", "-cq6", "-tp", "1,3"],
])
def test_fit_hbm_table_matches_reference(argv, monkeypatch):
    argv = argv + ["--hbm_gib", "16"]
    want = _ref("util/fit_hbm.py", argv, monkeypatch)
    got, text = _port(fit_hbm.main, argv, monkeypatch)
    assert text == want


def test_fit_hbm_reads_the_model_directory(monkeypatch):
    """The reference's -m builds ModelConfig(model_dir), which reads no
    config.json, and plans for the default Llama-2-7B geometry; the port
    reads the directory: its table equals the reference script's with the
    config read as ModelConfig.from_dir reads it."""
    import exllamav2_tpu.config as RC
    flags = ["-b", "3.0", "-cq8", "-ctx", "100000", "--hbm_gib", "16"]
    ref_dir = _ref("util/fit_hbm.py", ["-m", TRAINED] + flags, monkeypatch)
    ref_7b = _ref("util/fit_hbm.py", ["--preset", "7b"] + flags, monkeypatch)
    assert ref_dir.replace(TRAINED, "7b") == ref_7b      # the fault
    with monkeypatch.context() as m:
        m.setattr(RC, "ModelConfig", RC.ModelConfig.from_dir)
        want = _ref("util/fit_hbm.py", ["-m", TRAINED] + flags, monkeypatch)
    got, text = _port(fit_hbm.main, ["-m", TRAINED] + flags, monkeypatch)
    assert text == want and text != ref_dir
    assert got["fits_at"] == 1


def test_fit_hbm_needs_a_card_or_hbm_gib(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit) as e:
        _port(fit_hbm.main, ["--preset", "7b"], monkeypatch)
    assert e.value.code == 2


# ---------------------------------------------- shard, unshard, converting

def _mixed_file(path):
    """A safetensors file with F16, F32, BF16 and I32 tensors."""
    st = STFile(os.path.join(TRAINED, "model.safetensors"))
    rng = np.random.default_rng(5)
    tensors, dtypes = {}, {}
    for k in st.keys():
        tensors[k] = np.array(st.get_tensor(k))
    st.close()
    tensors["extra.f32"] = rng.standard_normal((300, 200)).astype(np.float32)
    tensors["extra.bf16"] = rng.integers(0, 1 << 16, (256, 300)).astype(
        np.uint16)
    dtypes["extra.bf16"] = "BF16"
    tensors["extra.i32"] = rng.integers(-9, 9, (1000,)).astype(np.int32)
    write_safetensors(path, tensors, dtypes=dtypes)
    return tensors


def _read_all(path_or_dir):
    from exllamav2_tpu_torch.stloader import TensorFileMap
    d = path_or_dir if os.path.isdir(path_or_dir) else None
    if d is None:
        st = STFile(path_or_dir)
        out = {k: (st.get_dtype(k), np.array(st.get_tensor(k)).tobytes())
               for k in st.keys()}
        st.close()
        return out
    tfm = TensorFileMap(d)
    out = {k: (tfm.get_dtype(k), np.array(tfm.get_tensor(k)).tobytes())
           for k in tfm.keys()}
    tfm.close()
    return out


def test_shard_unshard_match_reference(tmp_path, monkeypatch):
    dirs = {}
    for who in ("ref", "port"):
        d = tmp_path / who
        d.mkdir()
        tensors = _mixed_file(str(d / "model.safetensors"))
        dirs[who] = d
    _ref("util/shard.py", [str(dirs["ref"] / "model.safetensors"), "1"],
         monkeypatch)
    written, _ = _port(shard.main, [str(dirs["port"] / "model.safetensors"),
                                    "1"], monkeypatch)
    names = {w: sorted(os.listdir(d)) for w, d in dirs.items()}
    assert names["ref"] == names["port"] and len(written) >= 3
    for fn in names["ref"]:
        a = (dirs["ref"] / fn).read_bytes()
        b = (dirs["port"] / fn).read_bytes()
        assert a == b, fn
    for d in dirs.values():
        os.remove(d / "model.safetensors")
    _ref("util/unshard.py", [str(dirs["ref"])], monkeypatch)
    out, _ = _port(unshard.main, [str(dirs["port"])], monkeypatch)
    merged = {w: d / "model-merged.safetensors" for w, d in dirs.items()}
    assert out == str(merged["port"])
    assert merged["ref"].read_bytes() == merged["port"].read_bytes()
    back = _read_all(str(merged["port"]))
    assert set(back) == set(tensors)
    for k, arr in tensors.items():
        assert back[k][1] == np.ascontiguousarray(arr).tobytes(), k
    assert back["extra.bf16"][0] == "BF16"


def test_convert_safetensors_matches_reference(tmp_path, monkeypatch):
    g = torch.Generator().manual_seed(3)
    sd = {"a.bf16": torch.randn(33, 7, generator=g).bfloat16(),
          "b.f32": torch.randn(5, 9, generator=g),
          "c.f16": torch.randn(12, generator=g).half(),
          "d.i64": torch.arange(10)}
    src = tmp_path / "model.bin"
    torch.save(sd, src)
    ref_out, port_out = tmp_path / "ref.safetensors", \
        tmp_path / "port.safetensors"
    _ref("util/convert_safetensors.py", [str(src), str(ref_out)],
         monkeypatch)
    out, _ = _port(convert_safetensors.main, [str(src), str(port_out)],
                   monkeypatch)
    assert out == str(port_out)
    assert ref_out.read_bytes() == port_out.read_bytes()
    back = _read_all(str(port_out))
    assert set(back) == set(sd)
    for k, t in sd.items():
        raw = t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
        assert back[k][1] == raw.numpy().tobytes(), k
    assert back["a.bf16"][0] == "BF16"
    _, _ = _port(convert_safetensors.main, [str(src)], monkeypatch)
    assert (tmp_path / "model.safetensors").exists()


# ------------------------------------------------------------- mmlu, humaneval

def test_mmlu_matches_reference(tmp_path, monkeypatch):
    from exllamav2_tpu.generator.dynamic import DynamicGenerator
    ds = tmp_path / "mmlu"
    ds.mkdir()
    rows = [["What is 1+1?", "1", "2", "3", "4", "B"],
            ["Color of the sky?", "blue", "red", "green", "pink", "A"],
            ["Opposite of up?", "left", "right", "down", "over", "C"],
            ["How many legs has a dog?", "two", "three", "four", "five",
             "C"],
            ["Largest planet?", "Mars", "Venus", "Earth", "Jupiter", "D"],
            ["Water freezes at?", "0 C", "50 C", "90 C", "10 C", "A"]]
    with open(ds / "toy_test.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    argv = ["-m", TRAINED, "-d", str(ds), "-fs", "2", "-l", "512"]
    jobs = []
    enqueue = DynamicGenerator.enqueue

    def recorded(self, job):
        jobs.append(job)
        return enqueue(self, job)

    with monkeypatch.context() as m:
        m.setattr(DynamicGenerator, "enqueue", recorded)
        want = _ref("eval/mmlu.py", argv, monkeypatch)
    got, text = _port(mmlu.main, argv + CPU, monkeypatch)
    assert got["total"] == len(jobs) == 4
    from exllamav2_tpu_torch.tokenizer import load_tokenizer
    tok = load_tokenizer(TRAINED)
    letters = [int(tok.encode(" " + l)[-1]) for l in "ABCD"]
    for prompt, pick, job in zip(got["prompts"], got["picks"], jobs):
        np.testing.assert_array_equal(tok.encode(prompt), job.prompt_ids)
        t = int(job.sequence[-1])
        assert pick == (letters.index(t) if t in letters else -1)
    assert text.splitlines()[-1] == want.splitlines()[-1]


def test_humaneval_matches_reference(tmp_path, monkeypatch):
    problems = [
        {"task_id": "Toy/0", "prompt": "def add(a, b):\n    ",
         "test": "def check(f):\n    assert f(1, 2) == 3\n",
         "entry_point": "add"},
        {"task_id": "Toy/1", "prompt": "def is_even(n):\n    return ",
         "test": "def check(f):\n    assert f(2)\n",
         "entry_point": "is_even"}]
    ds = tmp_path / "he.jsonl"
    ds.write_text("".join(json.dumps(p) + "\n" for p in problems))
    outs = {w: tmp_path / f"{w}.jsonl" for w in ("ref", "port")}
    common = ["-m", TRAINED, "-d", str(ds), "--max_tokens", "24", "-l",
              "512"]
    _ref("eval/humaneval.py", common + ["-o", str(outs["ref"])],
         monkeypatch)
    got, _ = _port(humaneval.main, common + ["-o", str(outs["port"])] + CPU,
                   monkeypatch)
    want = [json.loads(l) for l in outs["ref"].read_text().splitlines()]
    back = [json.loads(l) for l in outs["port"].read_text().splitlines()]
    assert back == want and len(back) == 2
    assert [c for _, c in got["completions"]] == \
        [r["completion"] for r in want]
    assert any(r["completion"] for r in want)


# ------------------------------------------------------------ chat, ws_server

def test_chat_two_turns_match_reference(monkeypatch):
    turns = "Hello there\nWhat is a list?\n"
    argv = ["-m", TRAINED, "-l", "512", "-topk", "1", "-repp", "1.0",
            "-maxr", "16", "-pt"]
    want = _ref("examples/chat.py", argv, monkeypatch, stdin=turns)
    replies, text = _port(chat.main, argv + CPU, monkeypatch, stdin=turns)
    assert len(replies) == 2 and all(replies)

    def strip(s):       # the timing lines carry rates
        return [l for l in s.splitlines() if " t/s, prompt " not in l]

    assert strip(text) == strip(want)
    for r in replies:
        assert r in text


def test_chat_lists_the_same_modes(monkeypatch):
    want = _ref("examples/chat.py", ["-m", TRAINED, "-modes"], monkeypatch)
    got, text = _port(chat.main, ["-m", TRAINED, "-modes"], monkeypatch)
    assert got == [] and text == want


def test_ws_server_matches_reference(monkeypatch):
    from exllamav2_tpu.server import websocket as RW
    from exllamav2_tpu_torch.server import websocket as PW
    served = []
    argv = ["-m", TRAINED, "-l", "256", "--port", "7999"]
    with monkeypatch.context() as m:
        m.setattr(RW.WebSocketServer, "serve_forever",
                  lambda self: served.append(self))
        m.setattr(PW.WebSocketServer, "serve_forever",
                  lambda self: served.append(self))
        want = _ref("examples/ws_server.py", argv, monkeypatch)
        _, text = _port(ws_server.main, argv + CPU, monkeypatch)
    assert text == want
    ref, port = served
    assert (port.ip, port.port) == (ref.ip, ref.port) == ("0.0.0.0", 7999)
    assert port.generator.max_seq_len == ref.generator.max_seq_len
    assert port.generator.cache.num_pages == ref.generator.cache.num_pages
