"""User-facing sampler settings (PyTorch port of
exllamav2_tpu/generator/sampler.py).

`Settings` keeps the reference-compatible field names; `stack_settings`
lowers a batch of them into the [B] tensors of ops/sampling.SamplingParams
on one device, with one host-to-device copy per element type.
`settings_rows` and `params_from_rows` are its two halves, for a caller that
uploads the rows itself (the serving step packs them with its other inputs
into one buffer).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from exllamav2_tpu_torch.device import resolve_device
from exllamav2_tpu_torch.ops.sampling import SamplingParams

__all__ = ["Settings", "stack_settings", "settings_rows",
           "params_from_rows"]


@dataclasses.dataclass
class Settings:
    token_repetition_penalty: float = 1.025
    token_repetition_range: int = -1
    token_repetition_decay: int = 0
    token_frequency_penalty: float = 0.0
    token_presence_penalty: float = 0.0
    temperature: float = 0.8
    smoothing_factor: float = 0.0
    min_temp: float = 0.0
    max_temp: float = 0.0
    temp_exponent: float = 1.0
    top_k: int = 50
    top_p: float = 0.8
    top_a: float = 0.0
    min_p: float = 0.0
    tfs: float = 0.0
    typical: float = 0.0
    skew: float = 0.0
    temperature_last: bool = False
    mirostat: bool = False
    mirostat_tau: float = 1.5
    mirostat_eta: float = 0.1
    mirostat_mu: float | None = None
    token_bias: np.ndarray | None = None      # [vocab] additive bias
    banned_tokens: list[int] | None = None
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    cfg_scale: float | None = None
    dry_allowed_length: int = 2
    dry_base: float = 1.75
    dry_multiplier: float = 0.0     # 0 disables
    dry_sequence_breakers: set[int] | None = None
    dry_range: int = 0
    dry_max_ngram: int = 20

    @staticmethod
    def greedy(**kwargs) -> "Settings":
        defaults = dict(temperature=1.0, token_repetition_penalty=1.0,
                        top_p=0.0, top_k=1)
        defaults.update(kwargs)
        return Settings(**defaults)

    def clone(self) -> "Settings":
        return dataclasses.replace(self)


# SamplingParams field -> Settings attribute, by element type
_F32 = {"temperature": "temperature", "smoothing_factor": "smoothing_factor",
        "top_p": "top_p", "top_a": "top_a", "min_p": "min_p", "tfs": "tfs",
        "typical": "typical", "skew": "skew", "mirostat_tau": "mirostat_tau",
        "mirostat_eta": "mirostat_eta", "min_temp": "min_temp",
        "max_temp": "max_temp", "temp_exponent": "temp_exponent",
        "xtc_probability": "xtc_probability",
        "xtc_threshold": "xtc_threshold",
        "rep_penalty": "token_repetition_penalty",
        "freq_penalty": "token_frequency_penalty",
        "pres_penalty": "token_presence_penalty",
        "dry_multiplier": "dry_multiplier", "dry_base": "dry_base"}
_I32 = {"top_k": "top_k", "rep_range": "token_repetition_range",
        "rep_decay": "token_repetition_decay",
        "dry_allowed_length": "dry_allowed_length", "dry_range": "dry_range"}
_BOOL = {"temperature_last": "temperature_last", "mirostat": "mirostat"}


# rows of settings_rows: f32 fields and the mirostat mu, int32 fields and the
# eight DRY breaker columns, bool fields
ROWS = (len(_F32) + 1, len(_I32) + 8, len(_BOOL))


def settings_rows(settings: list[Settings],
                  mu_state: list[float] | None = None):
    """Per-job Settings as host rows (f32 [ROWS[0], B], int32 [ROWS[1], B],
    bool [ROWS[2], B]); mu_state overrides the mirostat mu of each row."""
    mu = mu_state if mu_state is not None else [
        (s.mirostat_mu or 0.0) for s in settings]
    f = np.array([[getattr(s, a) for s in settings] for a in _F32.values()]
                 + [mu], np.float32)
    i = np.concatenate([np.array([[getattr(s, a) for s in settings]
                                  for a in _I32.values()], np.int32)
                        .reshape(len(_I32), len(settings)),
                        _stack_breakers(settings).T])
    b = np.array([[getattr(s, a) for s in settings] for a in _BOOL.values()],
                 np.bool_)
    return f, i, b


def stack_settings(settings: list[Settings],
                   mu_state: list[float] | None = None,
                   device=None) -> SamplingParams:
    """Stack per-job Settings into [B] tensors on `device` (the card by
    default); mu_state overrides the mirostat mu of each row."""
    device = resolve_device(device)
    return params_from_rows(*(torch.from_numpy(x).to(device)
                              for x in settings_rows(settings, mu_state)))


def params_from_rows(ft: torch.Tensor, it: torch.Tensor,
                     bt: torch.Tensor) -> SamplingParams:
    """SamplingParams over the rows of settings_rows, on the device they lie
    on (each field a view of one row)."""
    fields = dict(zip(_F32, ft))
    fields["mirostat_mu"] = ft[len(_F32)]
    fields.update(zip(_I32, it))
    fields["dry_breakers"] = it[len(_I32):].T
    fields.update(zip(_BOOL, bt))
    return SamplingParams(**fields)


def _stack_breakers(settings: list[Settings], width: int = 8) -> np.ndarray:
    rows = []
    for s in settings:
        b = sorted(s.dry_sequence_breakers)[:width] \
            if s.dry_sequence_breakers else []
        rows.append(b + [-1] * (width - len(b)))
    return np.array(rows, np.int32).reshape(len(settings), width)
