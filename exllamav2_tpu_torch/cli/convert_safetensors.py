"""Convert a torch pickle checkpoint (.bin/.pt) to safetensors (twin of the
reference's util/convert_safetensors.py; host only).

    python -m exllamav2_tpu_torch.cli.convert_safetensors <in.bin> [out.safetensors]
"""

import argparse
import os

import torch

from exllamav2_tpu_torch.stloader import write_safetensors


def main(argv=None) -> str:
    """-> the path written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("out", nargs="?", default=None)
    args = ap.parse_args(argv)
    out = args.out or os.path.splitext(args.src)[0] + ".safetensors"
    sd = torch.load(args.src, map_location="cpu", weights_only=True)
    tensors = {}
    dtypes = {}
    for name, t in sd.items():
        if t.dtype == torch.bfloat16:
            tensors[name] = t.view(torch.uint16).numpy()
            dtypes[name] = "BF16"
        else:
            tensors[name] = t.numpy()
    write_safetensors(out, tensors, dtypes=dtypes)
    print(f" -- wrote {out} ({len(tensors)} tensors)")
    return out


if __name__ == "__main__":
    main()
