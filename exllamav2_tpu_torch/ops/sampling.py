"""On-device token sampling (PyTorch port of exllamav2_tpu/ops/sampling.py).

The whole pipeline -- softmax with smoothing exponent, top-k / top-p / top-a
/ min-p / TFS / typical, mirostat, dynamic post-temperature, XTC, skew and
the multinomial pick -- runs as [B, V] torch ops on the logits' device; only
the sampled ids (and optional top probabilities) go back to the host. These
are plain torch ops: the reference has no kernel here either.

Every stage zeroes masked probabilities in descending-sorted order, so one
stable sort serves all prefix filters. Sorts and argsorts are stable, as the
reference's are, so tied probabilities pick the same tokens. Randomness
comes from an explicit torch.Generator, or from the uniform draws `u` a
caller hands in (the tests feed the reference's draws to compare tokens).
"""

from __future__ import annotations

import dataclasses

import torch

from exllamav2_tpu_torch.device import resolve_device

__all__ = ["SamplingParams", "sample", "apply_penalties", "apply_dry",
           "unpack_mask"]

_EPS = 1e-10
_BIG = 0x7FFFFFFF


@dataclasses.dataclass
class SamplingParams:
    """Per-sequence sampling settings, each a [B] tensor."""
    temperature: torch.Tensor
    smoothing_factor: torch.Tensor
    top_k: torch.Tensor            # int32; <=0 disables
    top_p: torch.Tensor            # <=0 or >=1 disables
    top_a: torch.Tensor            # <=0 disables
    min_p: torch.Tensor
    tfs: torch.Tensor
    typical: torch.Tensor
    skew: torch.Tensor
    temperature_last: torch.Tensor  # bool
    mirostat: torch.Tensor          # bool
    mirostat_mu: torch.Tensor       # 0 = uninitialized -> 2*tau
    mirostat_tau: torch.Tensor
    mirostat_eta: torch.Tensor
    min_temp: torch.Tensor
    max_temp: torch.Tensor
    temp_exponent: torch.Tensor
    xtc_probability: torch.Tensor
    xtc_threshold: torch.Tensor
    rep_penalty: torch.Tensor       # 1.0 disables
    rep_range: torch.Tensor         # int32; -1 = whole context
    rep_decay: torch.Tensor         # int32
    freq_penalty: torch.Tensor
    pres_penalty: torch.Tensor
    dry_multiplier: torch.Tensor    # 0 disables DRY
    dry_base: torch.Tensor
    dry_allowed_length: torch.Tensor   # int32
    dry_range: torch.Tensor            # int32; 0 = unlimited
    dry_breakers: torch.Tensor         # int32 [B, NB], -1 padded

    @classmethod
    def defaults(cls, batch: int, device=None, **over) -> "SamplingParams":
        """The reference's defaults for `batch` rows on `device` (the card
        by default); keyword arguments override single fields."""
        device = resolve_device(device)
        vals = dict(
            temperature=0.8, smoothing_factor=0.0, top_k=50, top_p=0.8,
            top_a=0.0, min_p=0.0, tfs=0.0, typical=0.0, skew=0.0,
            temperature_last=False, mirostat=False, mirostat_mu=0.0,
            mirostat_tau=1.5, mirostat_eta=0.1, min_temp=0.0, max_temp=0.0,
            temp_exponent=1.0, xtc_probability=0.0, xtc_threshold=0.1,
            rep_penalty=1.0, rep_range=-1, rep_decay=0, freq_penalty=0.0,
            pres_penalty=0.0, dry_multiplier=0.0, dry_base=1.75,
            dry_allowed_length=2, dry_range=0)
        vals.update(over)
        out = {}
        for k, v in vals.items():
            dt = (torch.bool if isinstance(v, bool) else torch.int32
                  if isinstance(v, int) else torch.float32)
            out[k] = torch.full((batch,), v, dtype=dt, device=device)
        out["dry_breakers"] = torch.full((batch, 8), -1, dtype=torch.int32,
                                         device=device)
        return cls(**out)


def apply_penalties(logits: torch.Tensor, seq: torch.Tensor,
                    seq_len: torch.Tensor, p: SamplingParams) -> torch.Tensor:
    """Repetition / frequency / presence penalties.

    logits [B, V]; seq [B, W] past token ids left-aligned (anything < 0 or
    >= V beyond seq_len); seq_len [B] valid lengths. Full penalty over the
    last `rep_range` tokens, then a linear decay to zero over the next
    `rep_decay`; rep and pres apply once at a token's newest occurrence,
    freq accumulates per occurrence."""
    bsz, v = logits.shape
    w = seq.shape[1]
    dev = logits.device
    seq = seq.long()
    seq_len = seq_len.long()
    pos = torch.arange(w, device=dev)[None, :]               # [1, W]
    age = seq_len[:, None] - 1 - pos                         # [B, W], 0=newest
    valid = (age >= 0) & (seq >= 0) & (seq < v)

    sust = torch.where(p.rep_range < 0, seq_len, p.rep_range.long())[:, None]
    decay_i = p.rep_decay.long()[:, None]
    decay = decay_i.float()
    over = torch.clamp(age - sust + 1, min=0).float()
    in_range = valid & (age < sust + decay_i)
    dec_frac = torch.where(decay > 0, torch.clamp(over / decay, max=1.0),
                           (over > 0).float())

    rep = p.rep_penalty[:, None]
    rep_w = rep + (1.0 - rep) * dec_frac
    freq_w = p.freq_penalty[:, None] * (1.0 - dec_frac)
    pres_w = p.pres_penalty[:, None] * (1.0 - dec_frac)

    tok = torch.where(in_range, seq, torch.full_like(seq, v))  # dump col v
    newest = torch.full((bsz, v + 1), _BIG, dtype=torch.long, device=dev)
    newest = newest.scatter_reduce(
        1, tok, torch.where(in_range, age, torch.full_like(age, _BIG)),
        "amin", include_self=True)[:, :v]
    seen = newest < _BIG
    at_newest = in_range & (age == torch.gather(
        newest, 1, torch.clamp(tok, max=v - 1)))

    def scatter(vals, how):
        z = torch.zeros((bsz, v + 1), dtype=torch.float32, device=dev)
        return z.scatter_reduce(1, tok, vals, how, include_self=True)[:, :v]

    zero = torch.zeros_like(rep_w)
    rep_at = scatter(torch.where(at_newest, rep_w, zero), "amax")
    pres_at = scatter(torch.where(at_newest, pres_w, zero), "amax")
    freq_sum = scatter(torch.where(in_range, freq_w, zero), "sum")

    rep_at = torch.where(seen, torch.clamp(rep_at, min=1e-6),
                         torch.ones_like(rep_at))
    out = torch.where(logits > 0, logits / rep_at, logits * rep_at)
    return out - torch.where(seen, pres_at, torch.zeros_like(pres_at)) \
        - freq_sum


def unpack_mask(packed: torch.Tensor, v: int) -> torch.Tensor:
    """Packed uint8 bitmask [B, ceil(V/8)] -> bool [B, V] (LSB first)."""
    b = packed.shape[0]
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(b, -1)[:, :v] != 0


def apply_dry(logits: torch.Tensor, seq: torch.Tensor,
              seq_len: torch.Tensor, multiplier: torch.Tensor,
              base: torch.Tensor, allowed_length: torch.Tensor,
              dry_range: torch.Tensor, breakers: torch.Tensor,
              max_ngram: int = 20) -> torch.Tensor:
    """DRY repetition penalty.

    For every past position i, the length of the longest suffix match
    seq[i-k] == seq[L-1-k], k = 0..max_ngram-1 (stopping at sequence
    breakers); the token that followed position i is penalized by
    multiplier * base^(match_len - allowed_length). seq [B, W] (-1 padded),
    seq_len [B]; breakers [B, NB] (-1 padded). multiplier == 0 disables."""
    bsz, v = logits.shape
    w = seq.shape[1]
    dev = logits.device
    seq = seq.long()
    seq_len = seq_len.long()
    pos = torch.arange(w, device=dev)[None, :]
    last = seq_len[:, None] - 1                              # index of z-1
    valid = (pos < seq_len[:, None]) & (seq >= 0)

    is_break = torch.zeros_like(valid)
    for jb in range(breakers.shape[1]):
        bcol = breakers[:, jb:jb + 1].long()
        is_break |= (seq == bcol) & (bcol >= 0)

    mlen = torch.zeros((bsz, w), dtype=torch.long, device=dev)
    alive = torch.ones((bsz, w), dtype=torch.bool, device=dev)
    seq_pad = torch.where(valid, seq, torch.full_like(seq, -2))
    for k in range(max_ngram):
        idx_i = pos - k
        idx_t = last - k
        ii = torch.clamp(idx_i, min=0).expand(bsz, w)
        tt = torch.clamp(idx_t, min=0).expand(bsz, w)
        a = torch.gather(seq_pad, 1, ii)
        bb = torch.gather(seq_pad, 1, tt)
        ok = (a == bb) & (idx_i >= 0) & (idx_t >= 0) & (a >= 0)
        ok &= ~torch.gather(is_break, 1, ii) & ~torch.gather(is_break, 1, tt)
        alive &= ok
        mlen = torch.where(alive, torch.full_like(mlen, k + 1), mlen)

    in_range = torch.where(dry_range[:, None] > 0,
                           pos >= seq_len[:, None] - dry_range.long()[:, None],
                           torch.ones_like(valid))
    nxt = torch.gather(seq_pad, 1,
                       torch.clamp(pos + 1, max=w - 1).expand(bsz, w))
    use = valid & in_range & (pos + 1 < seq_len[:, None]) & \
        (mlen >= allowed_length.long()[:, None]) & (nxt >= 0) & (nxt < v)

    tok = torch.where(use, nxt, torch.full_like(nxt, v))
    best = torch.zeros((bsz, v + 1), dtype=torch.long, device=dev)
    best = best.scatter_reduce(1, tok, torch.where(use, mlen,
                                                   torch.zeros_like(mlen)),
                               "amax", include_self=True)[:, :v]
    pen = multiplier[:, None] * torch.pow(
        torch.clamp(base[:, None], min=1e-6),
        (best - allowed_length.long()[:, None]).float())
    pen = torch.where(best > 0, pen, torch.zeros_like(pen))
    return torch.where(multiplier[:, None] > 0, logits - pen, logits)


def _norm(sp: torch.Tensor) -> torch.Tensor:
    return sp / torch.clamp(sp.sum(dim=-1, keepdim=True), min=_EPS)


def sample(logits: torch.Tensor, p: SamplingParams,
           generator: torch.Generator | None = None,
           logit_filter: torch.Tensor | None = None,
           xtc_mask: torch.Tensor | None = None, return_top: int = 0,
           u: torch.Tensor | None = None):
    """-> (tokens [B] int32, probs [B] f32, new_mirostat_mu [B]
    [, top_probs [B, n], top_tokens [B, n]]).

    logits [B, V] f32; logit_filter optional bool [B, V] (False = blocked);
    xtc_mask optional bool [B, V] (True = XTC may exclude). The multinomial
    pick uses u [B, 1] uniform draws in [0, 1) when given, else draws them
    from `generator`."""
    bsz, v = logits.shape
    dev = logits.device
    rank = torch.arange(v, device=dev)[None].expand(bsz, v)

    # greedy shortcut
    greedy = p.temperature < 0.01
    one = torch.ones_like(p.temperature)
    temp = torch.where(greedy, one, p.temperature)
    top_k = torch.where(greedy, torch.ones_like(p.top_k),
                        torch.where(p.top_k <= 0,
                                    torch.full_like(p.top_k, v), p.top_k))

    pre_t = torch.where(p.temperature_last, one, temp)
    post_t = torch.where(p.temperature_last, temp, one)
    smooth = p.smoothing_factor > 0
    pre_t = torch.where(smooth, pre_t / torch.clamp(p.smoothing_factor,
                                                    min=_EPS), pre_t)

    lg = logits.float()
    ninf = torch.full_like(lg, -torch.inf)
    if logit_filter is not None:
        lg = torch.where(logit_filter, lg, ninf)
    z = lg - lg.amax(dim=-1, keepdim=True)
    z = torch.where(torch.isfinite(z), z, ninf)
    z = torch.where(smooth[:, None], -z.abs() * z.abs(), z)
    probs = torch.softmax(z / pre_t[:, None], dim=-1)

    # one descending (stable) sort serves all prefix filters
    neg_sp, si = torch.sort(-probs, dim=-1, stable=True)
    sp = -neg_sp
    if xtc_mask is not None:
        xtc_sorted = torch.gather(xtc_mask, 1, si)
    else:
        xtc_sorted = torch.ones_like(sp, dtype=torch.bool)
    zero = torch.zeros_like(sp)

    def keep(sp, cond, enabled):
        cond = cond | (rank == 0) | ~enabled[:, None]
        return torch.where(cond, sp, zero)

    # top_k (prefix by construction)
    sp = torch.where(rank < top_k[:, None], sp, zero)

    # top_p: keep while the exclusive cumsum is below the threshold
    q = _norm(sp)
    cum = torch.cumsum(q, dim=-1)
    en = (p.top_p > 0.0) & (p.top_p < 1.0)
    sp = keep(sp, (cum - q) < p.top_p[:, None], en)

    # top_a: q_i >= a * q0^2
    q = _norm(sp)
    q0 = q[:, :1]
    sp = keep(sp, q >= p.top_a[:, None] * q0 * q0, p.top_a > 0.0)

    # min_p: q_i >= min_p * q0
    q = _norm(sp)
    q0 = q[:, :1]
    en = (p.min_p > 0.0) & (p.min_p < 1.0)
    sp = keep(sp, q >= p.min_p[:, None] * q0, en)

    # tfs: cumulative normalized |2nd derivative| <= tfs (+1)
    q = _norm(sp)
    d = (-q[:, :-2] + 2.0 * q[:, 1:-1] - q[:, 2:]).abs()
    dsum = d.sum(dim=-1, keepdim=True)
    dcum = torch.cumsum(d / torch.clamp(dsum, min=_EPS), dim=-1)
    kept = (dcum <= p.tfs[:, None]).sum(dim=-1) + 1
    en = (p.tfs > 0.0) & (p.tfs < 1.0) & ((sp > 0).sum(dim=-1) >= 3)
    sp = keep(sp, rank < kept[:, None], en)

    # typical: the reference's y = p + ln(p + eps)
    q = _norm(sp)
    active = sp > 0.0
    y = q + torch.log(q + 1e-10)
    neg_ent = torch.where(active, q * y, zero).sum(dim=-1, keepdim=True)
    dev_ = torch.where(active, (y - neg_ent).abs(),
                       torch.full_like(q, torch.inf))
    order = torch.argsort(dev_, dim=-1, stable=True)
    dev_sorted_q = torch.gather(q, 1, order)
    cumprob = torch.cumsum(dev_sorted_q, dim=-1)
    num = (cumprob - dev_sorted_q < p.typical[:, None]).sum(dim=-1)
    num = torch.clamp(num, min=1)
    dev_rank = torch.argsort(order, dim=-1, stable=True)
    en = (p.typical > 0.0) & (p.typical < 1.0)
    sp = keep(sp, dev_rank < num[:, None], en)

    # mirostat: drop tokens with surprise > mu
    mu = torch.where(p.mirostat_mu == 0.0, 2.0 * p.mirostat_tau,
                     p.mirostat_mu)
    q = _norm(sp)
    sp = keep(sp, q >= torch.exp2(-mu)[:, None], p.mirostat)

    # post-softmax / dynamic temperature
    q = _norm(sp)
    active = q > 0.0
    ent = -torch.where(active, q * torch.log(q + _EPS), zero).sum(dim=-1)
    ncand = torch.clamp(active.sum(dim=-1), min=2)
    max_ent = torch.log(ncand.float())
    dyn = p.max_temp > p.min_temp
    dyn_t = p.min_temp + (p.max_temp - p.min_temp) * \
        (ent / torch.clamp(max_ent, min=_EPS)) ** p.temp_exponent
    pt = torch.where(dyn, dyn_t, post_t)
    do_post = dyn | (post_t != 1.0)
    qp = torch.where(active, q ** (1.0 / torch.clamp(pt, min=_EPS))[:, None],
                     zero)
    sp = torch.where(do_post[:, None], qp, q)

    # xtc (intended semantics of the reference's sampler)
    q = _norm(sp)
    over = (q >= p.xtc_threshold[:, None]) & xtc_sorted & (q > 0.0)
    x_tokens = over.sum(dim=-1, keepdim=True)
    minp_over = torch.where(over, q, torch.full_like(q, 2.0)).amin(
        dim=-1, keepdim=True)
    x_mass = torch.where(over, q, zero).sum(dim=-1, keepdim=True) - minp_over
    excl = over & ~(over & (q == minp_over))
    xp = p.xtc_probability[:, None]
    boost = 1.0 + xp * x_mass / torch.clamp(1.0 - x_mass, min=_EPS)
    q_xtc = torch.where(excl, q * (1.0 - xp), q * boost)
    apply_xtc = (p.xtc_probability > 0.0)[:, None] & (x_tokens >= 2)
    sp = torch.where(apply_xtc, q_xtc, sp)

    # multinomial pick: inverse CDF in sorted order at r^exp(-skew) * 0.9998
    s_final = sp.sum(dim=-1, keepdim=True)
    if u is None:
        u = torch.rand((bsz, 1), generator=generator, device=dev)
    r = u.to(dev).float() ** torch.exp(-p.skew)[:, None]
    r = r * 0.9998 * s_final
    cdf = torch.cumsum(sp, dim=-1)
    chosen = torch.clamp((cdf < r).sum(dim=-1), max=v - 1)
    tokens = torch.gather(si, 1, chosen[:, None])[:, 0]
    qf = sp / torch.clamp(s_final, min=_EPS)
    chosen_p = torch.gather(qf, 1, chosen[:, None])[:, 0]

    # mirostat mu update
    surprise = -torch.log2(torch.clamp(chosen_p, min=_EPS))
    new_mu = torch.where(p.mirostat,
                         mu + p.mirostat_eta * (p.mirostat_tau - surprise),
                         p.mirostat_mu)

    if return_top > 0:
        neg_q, ti = torch.sort(-qf, dim=-1, stable=True)
        ti = torch.gather(si, 1, ti)
        return (tokens.to(torch.int32), chosen_p, new_mu,
                -neg_q[:, :return_top], ti[:, :return_top].to(torch.int32))
    return tokens.to(torch.int32), chosen_p, new_mu
