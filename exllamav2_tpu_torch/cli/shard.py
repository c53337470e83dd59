"""Shard a single .safetensors file by size (twin of the reference's
util/shard.py; host only).

    python -m exllamav2_tpu_torch.cli.shard <model.safetensors> <max_shard_MB>

Writes <base>-0000i-of-0000n.safetensors and <base>.safetensors.index.json.
"""

import argparse
import json
import os

from exllamav2_tpu_torch.stloader import STFile, write_safetensors


def main(argv=None) -> list[str]:
    """-> the shard paths written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("size_mb", type=int)
    args = ap.parse_args(argv)
    path, limit = args.path, args.size_mb * 1024 * 1024
    st = STFile(path)
    shards: list[dict] = [{}]
    sizes = [0]
    dtypes: list[dict] = [{}]
    for name in st.keys():
        t = st.get_tensor(name)
        if sizes[-1] + t.nbytes > limit and shards[-1]:
            shards.append({})
            sizes.append(0)
            dtypes.append({})
        shards[-1][name] = t
        if st.get_dtype(name) == "BF16":
            dtypes[-1][name] = "BF16"
        sizes[-1] += t.nbytes

    base = path[:-len(".safetensors")]
    n = len(shards)
    index = {"metadata": {"total_size": sum(sizes)}, "weight_map": {}}
    written = []
    for i, (shard, dt) in enumerate(zip(shards, dtypes)):
        fn = f"{base}-{i + 1:05d}-of-{n:05d}.safetensors"
        write_safetensors(fn, shard, dtypes=dt)
        for name in shard:
            index["weight_map"][name] = os.path.basename(fn)
        print(f" -- wrote {fn} ({sizes[i] / 1e6:.1f} MB)")
        written.append(fn)
    with open(base + ".safetensors.index.json", "w") as f:
        json.dump(index, f, indent=2)
    st.close()
    return written


if __name__ == "__main__":
    main()
