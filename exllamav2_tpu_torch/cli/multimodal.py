"""Vision-language example (twin of the reference's examples/
multimodal.py): load a VLM checkpoint (Pixtral / Qwen2-VL / Gemma3
family), embed an image through the vision tower, and generate grounded
text.

    python -m exllamav2_tpu_torch.cli.multimodal -m <model_dir> --image <path>

The image is read with PIL; a .npy file (an [H, W, 3] uint8 array) is read
with numpy, so the example also runs where PIL is not installed.
"""

import argparse
import json

import numpy as np


def open_image(path: str):
    """`path` as PIL opens it, or an [H, W, 3] uint8 array from a .npy
    file (or, without PIL, a .json file of nested lists)."""
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
    except ImportError:
        with open(path) as f:
            return np.asarray(json.load(f), np.uint8)
    return Image.open(path)


def main(argv=None) -> str:
    """-> the completion."""
    from exllamav2_tpu_torch.model_init import add_args, init
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.vlm import VisionTower
    ap = argparse.ArgumentParser()
    add_args(ap)
    ap.add_argument("--image", required=True, help="image file path")
    ap.add_argument("--prompt", default="Describe this image: <img>")
    args = ap.parse_args(argv)

    model, tokenizer, generator = init(args)
    tower = VisionTower(model.config, device=model.device)

    image = open_image(args.image)
    emb = tower.get_image_embeddings(model, tokenizer, image,
                                     text_alias="<img>")

    out = generator.generate(args.prompt, max_new_tokens=200,
                             settings=Settings(temperature=0.6),
                             embeddings=[emb])
    print(out)
    return out


if __name__ == "__main__":
    main()
