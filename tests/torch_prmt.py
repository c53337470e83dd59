"""numpy forms of the CUDA byte permute (prmt) and of the 4x4 byte transpose
the tool kernels build from it, shared by the tests that emulate their
fragment maps."""

import numpy as np

U32 = np.uint32


def byte_perm(x, y, sel):
    """__byte_perm(x, y, sel): byte i of the result is byte (sel >> 4i) & 7
    of the 8-byte value y:x (selectors below 8 only)."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        k = (sel >> (4 * i)) & 7
        assert (sel >> (4 * i)) & 8 == 0
        out |= ((both >> np.uint64(8 * k)) & np.uint64(0xFF)) \
            << np.uint64(8 * i)
    return out.astype(U32)


def byte_of4(m0, m1, m2, m3, b):
    """byte_of4 of the source: byte b of word i into byte i."""
    pair = 0x5140 if b < 2 else 0x7362
    x01 = byte_perm(m0, m1, pair)
    x23 = byte_perm(m2, m3, pair)
    return byte_perm(x01, x23, 0x7632 if b & 1 else 0x5410)
