"""Safetensors reading: header parse + zero-copy mmap tensor views.

Copy of exllamav2_tpu/stloader.py: this package imports
nothing of the JAX package, whose __init__ imports JAX.

TPU-native replacement for the reference's STFile + C++ bulk reader
(exllamav2/stloader.py, exllamav2_ext/ext_stloader.cpp). The reference
spins 8 threads copying 1 MiB blocks into pinned memory and then async-H2D;
on TPU the right primitive is an mmap'ed numpy view handed to
jax.device_put (XLA does the DMA directly from the page cache), so the
whole native layer collapses into ~100 lines of Python with equal
throughput for bulk loads.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import numpy as np

__all__ = ["STFile", "TensorFileMap", "DTYPE_MAP"]

DTYPE_MAP = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": None,           # numpy has no bf16; exposed as uint16 raw
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


class STFile:
    """One .safetensors shard, lazily mmap'ed."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            header_len = struct.unpack("<Q", f.read(8))[0]
            header = json.loads(f.read(header_len))
        self.header_size = 8 + header_len
        self.metadata = header.pop("__metadata__", None)
        self.entries = header            # name -> {dtype, shape, data_offsets}
        self._mm: mmap.mmap | None = None

    def keys(self):
        return self.entries.keys()

    def _map(self) -> mmap.mmap:
        if self._mm is None:
            fd = os.open(self.path, os.O_RDONLY)
            try:
                self._mm = mmap.mmap(fd, 0, prot=mmap.PROT_READ)
            finally:
                os.close(fd)
        return self._mm

    def get_tensor(self, name: str) -> np.ndarray:
        """Zero-copy numpy view of a stored tensor.

        BF16 tensors are returned as uint16 with attribute-free raw bits;
        callers that want jax arrays use `get_jax` which views them as
        jnp.bfloat16.
        """
        ent = self.entries[name]
        dt = DTYPE_MAP[ent["dtype"]]
        start, end = ent["data_offsets"]
        mm = self._map()
        buf = memoryview(mm)[self.header_size + start:self.header_size + end]
        if ent["dtype"] == "BF16":
            arr = np.frombuffer(buf, dtype=np.uint16)
        else:
            arr = np.frombuffer(buf, dtype=dt)
        return arr.reshape(ent["shape"])

    def get_dtype(self, name: str) -> str:
        return self.entries[name]["dtype"]

    def get_shape(self, name: str) -> list[int]:
        return self.entries[name]["shape"]

    def close(self):
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # zero-copy tensor views still reference the mapping; the
                # OS reclaims it when the last view is garbage-collected
                pass
            self._mm = None


def apply_keymap(name: str, keymap: tuple) -> str:
    """Rename a stored tensor name to the canonical layout (reference
    architecture.py:81-106 keymaps): each (src, dst) pair substitutes;
    a "$"-prefixed src anchors at the start of the name."""
    for src, dst in keymap:
        if src.startswith("$"):
            if name.startswith(src[1:]):
                name = dst + name[len(src) - 1:]
        else:
            name = name.replace(src, dst)
    return name


class TensorFileMap:
    """Maps tensor name -> shard across a model directory.

    Mirrors ExLlamaV2Config.tensor_file_map (config.py:424-435): scans
    *.safetensors in the directory, preferring the index json when present.
    """

    def __init__(self, model_dir: str, keymap: tuple = ()):
        self.model_dir = model_dir
        self.files: dict[str, STFile] = {}
        self.map: dict[str, STFile] = {}
        self._stored: dict[str, str] = {}     # canonical -> stored name
        names = sorted(fn for fn in os.listdir(model_dir)
                       if fn.endswith(".safetensors"))
        if not names:
            raise FileNotFoundError(f"no .safetensors in {model_dir}")
        for fn in names:
            st = STFile(os.path.join(model_dir, fn))
            self.files[fn] = st
            for key in st.keys():
                canon = apply_keymap(key, keymap)
                self.map[canon] = st
                self._stored[canon] = key

    def set_keymap(self, keymap: tuple):
        """Re-index under an architecture keymap (config knows the arch
        only after reading config.json, which needs no tensors)."""
        old = {self._stored[c]: st for c, st in self.map.items()}
        self.map = {}
        self._stored = {}
        for key, st in old.items():
            canon = apply_keymap(key, keymap)
            self.map[canon] = st
            self._stored[canon] = key

    def __contains__(self, key: str) -> bool:
        return key in self.map

    def keys(self):
        return self.map.keys()

    def get_tensor(self, key: str) -> np.ndarray:
        return self.map[key].get_tensor(self._stored[key])

    def get_dtype(self, key: str) -> str:
        return self.map[key].get_dtype(self._stored[key])

    def get_shape(self, key: str) -> list[int]:
        return self.map[key].get_shape(self._stored[key])

    def has_prefix(self, prefix: str) -> bool:
        return any(k.startswith(prefix) for k in self.map)

    def close(self):
        for st in self.files.values():
            st.close()


_INV_DTYPE = {np.dtype(np.float64): "F64", np.dtype(np.float32): "F32",
              np.dtype(np.float16): "F16", np.dtype(np.int64): "I64",
              np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
              np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8",
              np.dtype(np.bool_): "BOOL", np.dtype(np.uint32): "I32",
              np.dtype(np.uint16): "I16"}


def write_safetensors(path: str, tensors: dict[str, np.ndarray],
                      metadata: dict | None = None,
                      dtypes: dict[str, str] | None = None):
    """Write a .safetensors file (converter / test-fixture path).

    uint32/uint16 arrays are stored bit-identically as I32/I16 (the EXL2
    convention: q_weight etc. are int32 carriers of packed bits);
    `dtypes` overrides the stored dtype tag per tensor (BF16 passthrough).
    """
    entries = {}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        nbytes = arr.nbytes
        entries[name] = {
            "dtype": (dtypes or {}).get(name, _INV_DTYPE[arr.dtype]),
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        blobs.append(arr.tobytes())
        offset += nbytes
    if metadata:
        entries["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    header = json.dumps(entries).encode()
    pad = (8 - len(header) % 8) % 8
    header += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for b in blobs:
            f.write(b)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Convert raw bf16 bits (uint16) to float32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_weight_f32(tfm: TensorFileMap, key: str) -> np.ndarray:
    """Read any float tensor as float32."""
    if tfm.get_dtype(key) == "BF16":
        return bf16_bits_to_f32(tfm.get_tensor(key))
    return tfm.get_tensor(key).astype(np.float32)
