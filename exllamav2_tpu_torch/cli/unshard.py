"""Merge sharded .safetensors into one file (twin of the reference's
util/unshard.py; host only).

    python -m exllamav2_tpu_torch.cli.unshard <model_dir_or_first_shard> [out.safetensors]
"""

import argparse
import os

from exllamav2_tpu_torch.stloader import TensorFileMap, write_safetensors


def main(argv=None) -> str:
    """-> the path written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("out", nargs="?", default=None)
    args = ap.parse_args(argv)
    src = args.src
    if os.path.isfile(src):
        src = os.path.dirname(src) or "."
    out = args.out or os.path.join(src, "model-merged.safetensors")
    tfm = TensorFileMap(src)
    tensors = {}
    dtypes = {}
    for name in tfm.keys():
        tensors[name] = tfm.get_tensor(name)
        if tfm.get_dtype(name) == "BF16":
            dtypes[name] = "BF16"
    write_safetensors(out, tensors, dtypes=dtypes)
    print(f" -- wrote {out} "
          f"({sum(t.nbytes for t in tensors.values()) / 1e6:.1f} MB)")
    tfm.close()
    return out


if __name__ == "__main__":
    main()
