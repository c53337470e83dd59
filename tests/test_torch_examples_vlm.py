"""The twins of the reference's vision-language examples (CPU) on tiny
random checkpoints from utils/testing.make_tiny_vlm (numpy only, so both
packages load the same files), with an image the test writes, Settings
greedy in both packages: the same standard output.

The three run on the qwen2 fixture with a peaked head (head_scale 6):
tests/test_torch_vlm.py holds every tower kind's rows and tokens against
the reference. The random model's 200 greedy bytes are tie-prone: with a
24 x 20 image (resized to 24 x 16) the packages' texts part at byte 40,
not measured here (its bytes are not text, so the common prefix gives no
token ids to teacher-force).
"""

import numpy as np
import pytest
import torch

from torch_examples import greedy_settings, run_port, run_ref


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _greedy(monkeypatch):
    greedy_settings(monkeypatch)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from PIL import Image
    from exllamav2_tpu_torch.utils.testing import make_tiny_vlm
    d = tmp_path_factory.mktemp("vlm")
    # 24 x 16 px: a size the qwen2 processor keeps (no resize), so the
    # .npy copy (numpy) gives the PNG's pixels (PIL)
    img = (np.random.default_rng(3).random((16, 24, 3)) * 255).astype(
        np.uint8)
    Image.fromarray(img).save(d / "img.png")
    np.save(d / "img.npy", img)
    # head_scale 6 peaks the random head's logits (flat ones tie, and a
    # tie parts the packages' greedy texts on f32 sum order alone)
    return {"qwen2": make_tiny_vlm(str(d / "qwen2"), "qwen2",
                                   head_scale=6.0),
            "png": str(d / "img.png"), "npy": str(d / "img.npy")}


def test_multimodal_matches_reference(files, monkeypatch):
    argv = ["-m", files["qwen2"], "--image", files["png"]]
    want = run_ref("examples/multimodal.py", argv, monkeypatch)
    got, text = run_port("multimodal", argv, monkeypatch)
    assert text == want and got + "\n" == text
    # the same pixels from a .npy file (read with numpy, no PIL)
    same, _ = run_port("multimodal", ["-m", files["qwen2"], "--image",
                                      files["npy"]], monkeypatch)
    assert same == got


def test_multimodal_grounding_matches_reference(files, monkeypatch):
    from exllamav2_tpu_torch.cli.multimodal_grounding import parse_boxes
    argv = ["-m", files["qwen2"], "-i", files["png"], "-maxr", "48"]
    want = run_ref("examples/multimodal_grounding.py", argv, monkeypatch)
    (out, boxes), text = run_port("multimodal_grounding", argv, monkeypatch)
    assert text == want
    assert boxes == parse_boxes(out, 24, 16)
    text = ("<|object_ref_start|>car<|object_ref_end|><|box_start|>"
            "(100,200),(500,1000)<|box_end|>")
    assert parse_boxes(text, 24, 20) == [("car", (2, 4, 12, 20))]


def test_multimodal_video_matches_reference(files, monkeypatch):
    argv = ["-m", files["qwen2"]]
    want = run_ref("examples/multimodal_video.py", argv, monkeypatch)
    got, text = run_port("multimodal_video", argv, monkeypatch)
    assert text == want and "frames ->" in text
