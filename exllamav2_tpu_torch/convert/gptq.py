"""Adaptive GPTQ quantization engine (PyTorch port of
exllamav2_tpu/convert/gptq.py).

  * AdaptiveQuantizer.find_params: per-group 4-bit sqrt-encoded column scales
    and the p-grid error search, one broadcast over [P+1, ..., rows, N];
    leading dimensions batch independent groups (quantize_rtn sends every
    group of a run at once);
  * AdaptiveGPTQ: Hessian accumulation (add_batch), activation-order
    permutation by the Hessian diagonal, damped Cholesky factorization with
    re-damping retries (prepare), blockwise GPTQ error propagation
    (quantize) and the RTN fast path of the measurement (quantize_rtn).

The per-row GPTQ recursion of one group (the reference's
_gptq_quant_range:218-229, a lax.fori_loop inside one jitted call) is
kernel G1 on the card, csrc/gptq.cu: one launch a group instead of about
eight eager launches a row; on a CPU tensor it is gptq_rows_plain, the same
loop in torch. The trailing update of the later rows is one f32 torch.addmm,
a plain large product that the reference also leaves outside any kernel.

Every product here is f32. Callers on the card run under full_f32(), which
turns TF32 off for their duration (convert_model does).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

__all__ = ["AdaptiveQuantizer", "AdaptiveGPTQ", "gptq_rows",
           "gptq_rows_plain", "gptq_quant_range", "gptq_quant_range_plain",
           "p_grid", "full_f32", "LAUNCHES", "MAX_BLOCK"]

# launches of csrc/gptq.cu, counted by its wrapper
LAUNCHES = {"gptq": 0}
# most rows a group may have on the card (the largest template of G1)
MAX_BLOCK = 128
_TEMPLATES = (32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
# w, its row stride, U, its row stride, scale, qzero, maxq, a, blk, n,
# template rows, q, dq, err, stream (csrc/gptq.cu gptq_rows)
_ARGTYPES = [_P, ctypes.c_longlong, _P, ctypes.c_longlong, _P,
             ctypes.c_float, ctypes.c_float, _I, _I, _I, _I, _P, _P, _P, _P]


@contextlib.contextmanager
def full_f32():
    """f32 products in full f32 on the card (TF32 off) while inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@functools.lru_cache(maxsize=None)
def _p_grid_np(start: float, stop: float, num: int) -> np.ndarray:
    div = num - 1
    r = np.float32(1.0) / np.float32(div)
    it = np.arange(div, dtype=np.float32)
    head = np.float32(start) * (np.float32(1.0) - it * r)
    # one rounding of head + it * (stop * r): the fused multiply-add the
    # reference's compiler makes of it (exact in f64, rounded once)
    tail = it.astype(np.float64) * np.float64(np.float32(stop) * r)
    out = (head.astype(np.float64) + tail).astype(np.float32)
    return np.concatenate([out, np.float32([stop])])


def p_grid(start: float, stop: float, num: int, device) -> torch.Tensor:
    """The reference's jnp.linspace(start, stop, num) in f32, bit for bit:
    s = i * f32(1/div), start * (1 - s) + i * (stop * f32(1/div)) with the
    last multiply-add fused, and the end point exact (torch.linspace rounds
    some points to the neighbouring f32)."""
    return torch.from_numpy(_p_grid_np(float(start), float(stop),
                                       int(num)).copy()).to(device)


class AdaptiveQuantizer:
    """Per-group scale search (adaptivegptq.py:20-74)."""

    def __init__(self, bits: int = 4, scale_bits: int = 4,
                 scale_range: float = 1.0, p_grid: int = 48,
                 min_p: float = 0.75, max_p: float = 1.25,
                 norm: float = 2.4):
        self.bits = bits
        self.scale_bits = scale_bits
        self.scale_range = scale_range
        self.maxq = 2 ** bits - 1
        self.qzero = (self.maxq + 1) / 2
        self.scale_maxq = 2 ** scale_bits - 1
        self.p_grid = p_grid
        self.min_p = min_p
        self.max_p = max_p
        self.norm = norm

    def find_params(self, x: torch.Tensor):
        """x [..., rows, n] f32 -> (scale f32 [..., n], qscale int16
        [..., n], qscale_max f32 [...]), each group (leading index) on its
        own.

        Scale encoding matches the packer: stored qs in [1,16],
        scale = fp16((qs^2) * fp16(qscale_max/256)).
        """
        xmax = x.abs().amax(dim=-2) + 1e-12
        base_scale = xmax / (self.maxq / 2)
        qscale_max = base_scale.amax(dim=-1, keepdim=True) * self.scale_range

        scale_tp = torch.sqrt(base_scale / qscale_max) * (self.scale_maxq + 1)
        qscale = torch.clamp(torch.round(scale_tp), 1, self.scale_maxq + 1)
        qscale_tw = (qscale / (self.scale_maxq + 1)) ** 2 * qscale_max

        # p-grid search: minimize sum |dq - x|^norm per column
        ps = p_grid(self.min_p, self.max_p, self.p_grid + 1, x.device)
        s = qscale_tw * ps.reshape(-1, *([1] * qscale_tw.dim()))
        s = s.unsqueeze(-2)                              # [P+1, ..., 1, n]
        q = torch.clamp(torch.round(x / s + self.qzero), 0, self.maxq)
        dq = (q - self.qzero) * s
        errs = (dq - x).abs().pow(self.norm).sum(dim=-2)  # [P+1, ..., n]
        best_p = ps[torch.argmin(errs.sum(dim=-1), dim=0)]    # [...]

        qscale_max_p = qscale_max[..., 0] * best_p
        # fp16-rounded final scales (sanity-test parity, adaptivegptq.py:72-74)
        smax16 = (qscale_max_p.half() / 256).half()
        scale = ((qscale * qscale).half() * smax16[..., None]).float()
        return scale, qscale.to(torch.int16), qscale_max_p


class AdaptiveGPTQ:
    """Hessian-aware quantizer for one linear layer (W^T [K, N] f32) on the
    device of the weight it is given."""

    def __init__(self, weights_t, percdamp: float = 0.12):
        self.w = torch.as_tensor(weights_t).float()            # [K, N]
        self.rows, self.columns = self.w.shape
        self.percdamp = percdamp
        self.hessian: torch.Tensor | None = None
        self.num_batches = 0
        self.perm = None
        self.invperm = None
        self.hessian_inv = None

    def add_batch(self, inputs):
        """inputs [..., K] activations; H += X^T X (adaptivegptq.py:196)."""
        x = torch.as_tensor(inputs).to(self.w.device,
                                       torch.float32).reshape(-1, self.rows)
        h = x.T @ x
        self.hessian = h if self.hessian is None else self.hessian + h
        self.num_batches += 1

    def reuse_h(self, other: "AdaptiveGPTQ"):
        """Share prepared H across q/k/v / gate/up (adaptivegptq.py:605):
        the permutation and the factor are the other's tensors, not copies."""
        self.perm = other.perm
        self.invperm = other.invperm
        self.hessian_inv = other.hessian_inv
        self.w = self.w[self.perm]

    def prepare(self):
        """Act-order sort + damped Cholesky of H^-1 (adaptivegptq.py:251).

        A factorization that fails (cholesky_ex's info, or a NaN: the
        reference's jnp.linalg.cholesky returns NaN where torch's raising
        cholesky would throw) is retried with the damping doubled, ten
        times in all."""
        dev = self.w.device
        eye = torch.eye(self.rows, dtype=torch.float32, device=dev)
        if self.hessian is None or self.num_batches == 0:
            h = eye
        else:
            h = self.hessian / self.num_batches
        diag = torch.diagonal(h)
        self.perm = torch.argsort(-diag, stable=True)      # as jnp.argsort
        self.invperm = torch.argsort(self.perm)
        h = h[self.perm][:, self.perm]
        self.w = self.w[self.perm]

        damp = torch.clamp_min(self.percdamp * torch.mean(torch.diagonal(h)),
                               1e-5)
        for attempt in range(10):
            # re-damp on failure (adaptivegptq.py:318-330)
            hd = h + eye * damp * (2.0 ** attempt)
            l, info = torch.linalg.cholesky_ex(hd)
            if int(info) != 0:
                continue
            hinv = torch.cholesky_solve(eye, l)
            # upper factor U with hinv = U^T U: U = chol(hinv)^T
            u, info = torch.linalg.cholesky_ex(hinv)
            if int(info) == 0 and not bool(torch.isnan(u).any()):
                self.hessian_inv = u.T.contiguous()
                self.hessian = None
                return
        raise ValueError("Hessian is not invertible")

    def quantize(self, bits_groups: list[tuple[int, int, int]],
                 scale_bits: int = 4) -> dict:
        """Quantize with per-group bit widths.

        bits_groups: list of (bits, row_start, row_end) covering [0, K).
        -> dict of tensors on the weight's device: q (uint16 [K, N],
        permuted order), dq (f32 [K, N]), scale / qscale [G, N],
        qscale_max [G], the bit list, perm and invperm. Each group's row
        recursion is gptq_rows (kernel G1 on the card)."""
        w = self.w.clone()
        hinv = self.hessian_inv
        k, n = w.shape
        q_out = torch.empty((k, n), dtype=torch.uint16, device=w.device)
        dq_out = torch.empty((k, n), dtype=torch.float32, device=w.device)
        scales, qscales, qscale_maxs, group_bits = [], [], [], []
        for (bits, a, b) in bits_groups:
            quantizer = AdaptiveQuantizer(bits=bits, scale_bits=scale_bits)
            scale, qscale, qmax = quantizer.find_params(w[a:b])
            scales.append(scale)
            qscales.append(qscale)
            qscale_maxs.append(qmax)
            group_bits.append(bits)
            q_blk, dq_blk, w = gptq_quant_range(
                w, hinv, scale, quantizer.qzero, quantizer.maxq, a, b - a)
            q_out[a:b] = q_blk
            dq_out[a:b] = dq_blk
        return {
            "q": q_out,
            "dq": dq_out,
            "scale": torch.stack(scales),
            "qscale": torch.stack(qscales),
            "qscale_max": torch.stack(qscale_maxs),
            "bits": group_bits,
            "perm": self.perm,
            "invperm": self.invperm,
        }

    def quantize_rtn(self, bits_groups: list[tuple[int, int, int]],
                     scale_bits: int = 4,
                     max_elems: int = 1 << 26) -> torch.Tensor:
        """Fast RTN dequant-reconstruction for measurement
        (quantize_rtn_inplace, adaptivegptq.py:356-455) -> dq [K, N] in
        permuted order. Consecutive groups of one width and size go through
        find_params together, at most `max_elems` elements of its
        [P+1, groups, rows, N] sweep at a time."""
        dq = torch.empty_like(self.w)
        i = 0
        while i < len(bits_groups):
            bits, a, b = bits_groups[i]
            j = i + 1
            while (j < len(bits_groups) and bits_groups[j][0] == bits
                   and bits_groups[j][2] - bits_groups[j][1] == b - a):
                j += 1
            quantizer = AdaptiveQuantizer(bits=bits, scale_bits=scale_bits,
                                          p_grid=16)
            gs = b - a
            step = max(1, max_elems // ((quantizer.p_grid + 1) * gs
                                        * self.columns))
            for g0 in range(i, j, step):
                g1 = min(j, g0 + step)
                r0, r1 = bits_groups[g0][1], bits_groups[g1 - 1][2]
                grp = self.w[r0:r1].reshape(g1 - g0, gs, self.columns)
                scale, _, _ = quantizer.find_params(grp)
                scale = scale[:, None]
                q = torch.clamp(torch.round(grp / scale + quantizer.qzero),
                                0, quantizer.maxq)
                dq[r0:r1] = ((q - quantizer.qzero) * scale).reshape(
                    r1 - r0, self.columns)
            i = j
        return dq


def gptq_rows_plain(w: torch.Tensor, hinv: torch.Tensor, scale: torch.Tensor,
                    qzero: float, maxq: float, a: int, blk: int):
    """Plain version of kernel G1: the GPTQ recursion over rows
    [a, a+blk) of w [K, N] f32 (already updated by earlier groups) with
    hinv the upper Cholesky factor of H^-1 (hinv = U^T U). Per row i:
    quantize, err_i = (w_i - dq_i) / U[i, i], and the rows j > i of the
    group take w_j - err_i * U[i, j] (a product, then a difference: two
    roundings, as the reference). -> (q uint16, dq f32, err f32), each
    [blk, N]; w is not written."""
    wb = w[a:a + blk].clone()
    hblk = hinv[a:a + blk, a:a + blk]
    q = torch.empty_like(wb)
    dq = torch.empty_like(wb)
    errs = torch.empty_like(wb)
    for i in range(blk):
        wi = wb[i]
        qi = torch.clamp(torch.round(wi / scale + qzero), 0, maxq)
        dqi = (qi - qzero) * scale
        e = (wi - dqi) / hblk[i, i]
        wb[i + 1:] -= e[None, :] * hblk[i, i + 1:, None]
        q[i], dq[i], errs[i] = qi, dqi, e
    return q.to(torch.uint16), dq, errs


def _template(blk: int) -> int:
    for t in _TEMPLATES:
        if blk <= t:
            return t
    raise NotImplementedError(f"GPTQ groups of {blk} rows: kernel G1 takes "
                              f"at most {MAX_BLOCK}")


def _kernel_rows(w, hinv, scale, qzero, maxq, a, blk):
    from exllamav2_tpu_torch import _build
    k, n = w.shape
    if (w.dtype != torch.float32 or hinv.dtype != torch.float32
            or scale.dtype != torch.float32 or w.stride(1) != 1
            or hinv.stride(1) != 1 or not scale.is_contiguous()
            or hinv.shape != (k, k) or scale.shape != (n,)
            or not (w.device == hinv.device == scale.device)):
        raise ValueError(f"w {tuple(w.shape)} {w.dtype}, U "
                         f"{tuple(hinv.shape)} {hinv.dtype}, scale "
                         f"{tuple(scale.shape)} {scale.dtype}: want f32 on "
                         f"one device, rows of unit stride, U [K, K], "
                         f"scale [N]")
    if not (0 <= a and 0 < blk and a + blk <= k):
        raise ValueError(f"rows [{a}, {a + blk}) of {k}")
    tpl = _template(blk)
    dev = w.device
    q = torch.empty((blk, n), dtype=torch.uint16, device=dev)
    dq = torch.empty((blk, n), dtype=torch.float32, device=dev)
    err = torch.empty((blk, n), dtype=torch.float32, device=dev)
    fn = _build.function("gptq", "gptq_rows", _ARGTYPES)
    rc = fn(w.data_ptr(), w.stride(0), hinv.data_ptr(), hinv.stride(0),
            scale.data_ptr(), float(qzero), float(maxq), a, blk, n, tpl,
            q.data_ptr(), dq.data_ptr(), err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check("gptq", rc, "gptq_rows")
    LAUNCHES["gptq"] += 1
    return q, dq, err


def gptq_rows(w: torch.Tensor, hinv: torch.Tensor, scale: torch.Tensor,
              qzero: float, maxq: float, a: int, blk: int):
    """The GPTQ recursion over rows [a, a+blk) (gptq_rows_plain's
    function): kernel G1 (csrc/gptq.cu) on a card tensor, which raises
    rather than fall back; the plain loop on a CPU tensor."""
    if w.is_cuda:
        return _kernel_rows(w, hinv, scale, qzero, maxq, a, blk)
    return gptq_rows_plain(w, hinv, scale, qzero, maxq, a, blk)


def _trailing(w, hinv, errs, a, blk, dq):
    """w[b:] -= U[a:b, b:]^T @ errs (one f32 product over the later rows
    only: the reference's masked [K, N] product gives these rows), and the
    group's rows become dq. In place; returns w."""
    b = a + blk
    if b < w.shape[0]:
        w[b:].addmm_(hinv[a:b, b:].T, errs, alpha=-1.0)
    w[a:b] = dq
    return w


def gptq_quant_range(w: torch.Tensor, hinv: torch.Tensor,
                     scale: torch.Tensor, qzero: float, maxq: float,
                     a: int, blk: int):
    """GPTQ error-propagating quantization of rows [a, a+blk) of w [K, N]
    (updated IN PLACE, as the reference donates it): the rows through
    gptq_rows, the later rows through one product. -> (q, dq, w)."""
    q, dq, errs = gptq_rows(w, hinv, scale, qzero, maxq, a, blk)
    return q, dq, _trailing(w, hinv, errs, a, blk, dq)


def gptq_quant_range_plain(w: torch.Tensor, hinv: torch.Tensor,
                           scale: torch.Tensor, qzero: float, maxq: float,
                           a: int, blk: int):
    """gptq_quant_range with the plain row loop on any device (the
    reference's _gptq_quant_range:202). -> (q, dq, w), w updated in place."""
    q, dq, errs = gptq_rows_plain(w, hinv, scale, qzero, maxq, a, blk)
    return q, dq, _trailing(w, hinv, errs, a, blk, dq)
