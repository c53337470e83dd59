"""Visual grounding with Qwen2-VL / 2.5-VL: ask for bounding boxes (twin
of the reference's examples/multimodal_grounding.py).

Prompt the model to locate an object, parse the grounding tokens from the
completion and print pixel-space boxes. Qwen2-VL emits
<|object_ref_start|>label<|object_ref_end|><|box_start|>(x1,y1),(x2,y2)
<|box_end|> with coordinates normalized to 0-1000; Qwen2.5-VL emits JSON
boxes in absolute pixels.

    python -m exllamav2_tpu_torch.cli.multimodal_grounding -m <qwen2vl_dir> \\
        -i image.png -q "the red car"

The image is read with PIL (RGB); a .npy file is read with numpy and,
without PIL, any other path as a JSON array, as the reference does.
"""

import argparse
import json
import re

import numpy as np

BOX_RE = re.compile(
    r"<\|object_ref_start\|>(.*?)<\|object_ref_end\|>.*?"
    r"<\|box_start\|>\((\d+),(\d+)\),\((\d+),(\d+)\)<\|box_end\|>",
    re.S)


def parse_boxes(text: str, width: int, height: int):
    """-> [(label, (x1, y1, x2, y2) in pixels)] from grounding tokens
    (0-1000-normalized coordinates) or Qwen2.5-style JSON."""
    out = []
    for m in BOX_RE.finditer(text):
        label = m.group(1).strip()
        x1, y1, x2, y2 = (int(v) for v in m.groups()[1:])
        out.append((label, (x1 * width // 1000, y1 * height // 1000,
                            x2 * width // 1000, y2 * height // 1000)))
    if not out:
        try:
            for obj in json.loads(text[text.index("["):
                                       text.rindex("]") + 1]):
                box = obj.get("bbox_2d") or obj.get("bbox")
                if box and len(box) == 4:
                    out.append((obj.get("label", "?"), tuple(box)))
        except (ValueError, KeyError):
            pass
    return out


def _image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        with open(path) as f:
            return np.asarray(json.load(f), np.uint8)


def main(argv=None) -> tuple[str, list]:
    """-> (the completion, the parsed boxes)."""
    from exllamav2_tpu_torch import model_init
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.vlm import VisionTower
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("-q", "--query", default="every visible object")
    ap.add_argument("-maxr", type=int, default=256)
    args = ap.parse_args(argv)

    model, tokenizer, generator = model_init.init(args)
    tower = VisionTower(model.config, device=model.device)

    img = _image(args.image)
    h, w = img.shape[:2]

    emb = tower.get_image_embeddings(model, tokenizer, img,
                                     text_alias="<img>")
    prompt = (
        "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        "<|im_start|>user\n<img>\nLocate "
        f"{args.query} and output bounding boxes.<|im_end|>\n"
        "<|im_start|>assistant\n")
    out = generator.generate(
        prompt, max_new_tokens=args.maxr, settings=Settings.greedy(),
        embeddings=[emb], encode_special_tokens=True,
        stop_conditions=["<|im_end|>"])
    print(out)
    boxes = parse_boxes(out, w, h)
    for label, (x1, y1, x2, y2) in boxes:
        print(f" -- {label}: ({x1},{y1})-({x2},{y2})")
    if not boxes:
        print(" -- no grounding tokens found in the completion")
    return out, boxes


if __name__ == "__main__":
    main()
