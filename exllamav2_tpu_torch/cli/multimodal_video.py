"""Video input demo (twin of the reference's examples/multimodal_video.py):
a Qwen2-VL-family model takes a stack of frames as one MMEmbedding; frames
pair up through the temporal patch size and MRoPE advances the temporal
axis a frame pair.

    python -m exllamav2_tpu_torch.cli.multimodal_video -m <qwen2vl_dir> \\
        [-v frames_dir]
"""

import argparse
import os

import numpy as np


def load_frames(path, limit=16):
    """Directory of frame images (sorted by name) -> list of arrays.
    Without a directory, synthesizes a 4-frame moving-gradient clip."""
    if path:
        from PIL import Image
        names = sorted(os.listdir(path))[:limit]
        return [np.asarray(Image.open(os.path.join(path, n)).convert("RGB"))
                for n in names]
    xs = np.linspace(0, 1, 224)
    frames = []
    for t in range(4):
        g = (np.add.outer(xs, xs) / 2 + t * 0.1) % 1.0
        frames.append((np.stack([g, g * 0.5, 1 - g], -1)
                       * 255).astype(np.uint8))
    return frames


def main(argv=None) -> str:
    """-> the completion."""
    from exllamav2_tpu_torch.model_init import add_args, init
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.vlm import VisionTower
    ap = argparse.ArgumentParser()
    add_args(ap)
    ap.add_argument("-v", "--video_dir", default=None,
                    help="directory of frame images (default: synthetic)")
    ap.add_argument("--prompt",
                    default="<|im_start|>user\n<vid>\nDescribe the clip."
                            "<|im_end|>\n<|im_start|>assistant\n")
    args = ap.parse_args(argv)
    model, tokenizer, generator = init(args)

    tower = VisionTower(model.config, device=model.device)
    frames = load_frames(args.video_dir)
    video = tower.get_video_embeddings(model, tokenizer, frames,
                                       text_alias="<vid>")
    print(f" -- video: {len(frames)} frames -> "
          f"{video.thw_grid} (t, h, w) grid")
    out = generator.generate(args.prompt, max_new_tokens=128,
                             settings=Settings.greedy(),
                             embeddings=[video],
                             stop_conditions=["<|im_end|>"])
    print(out)
    return out


if __name__ == "__main__":
    main()
