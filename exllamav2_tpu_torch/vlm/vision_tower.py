"""Vision tower: patch embedding -> transformer -> multimodal projector
(PyTorch port of exllamav2_tpu/vlm/vision_tower.py).

Three tower families: pixtral (Llava, Mistral 3), qwen2 / qwen2.5 (Qwen2-VL,
Qwen2.5-VL) and SigLIP (Gemma 3). As in the reference:

  * the patch "conv" has stride == kernel, so it is a patch reshape and one
    dense product (its weight flattened to [Cin * prod(patch), Cout]);
  * attention is non-causal over the whole image, with qwen2.5's window
    blocks as a mask (-1e30 off the window) on every block but the
    full-attention ones; the S x S scores are materialised, as the
    reference does;
  * the 2-D (pixtral) and grid (qwen2) rotary tables are built on the host
    for each image size.

The tower reaches no kernel of the reference's: its products are plain
products, here ops/qmm._dot for the linears and a batched product for the
two attention products, with the reference's rounding points: bf16 operands
and f32 results (f32 operands on the CPU, ops/qmm.dot_dtype), scores times
hd ** -0.5, the softmax in f32 with the probabilities rounded to bf16, and a
bf16 residual. Tower weights stay unquantized (bf16 DenseLinears).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fn

from exllamav2_tpu_torch.config import ModelConfig
from exllamav2_tpu_torch.device import resolve_device
from exllamav2_tpu_torch.models.loader import load_linear, load_norm
from exllamav2_tpu_torch.models.modules import NormWeights
from exllamav2_tpu_torch.ops.qmm import _dot, linear_apply
from exllamav2_tpu_torch.quant.qtensor import from_dense, slice_columns
from exllamav2_tpu_torch.stloader import read_weight_f32
from exllamav2_tpu_torch.vlm import processing
from exllamav2_tpu_torch.vlm.mm_embedding import MMEmbedding

__all__ = ["VisionTower"]

_NEG = -1e30


class _VLayer(nn.Module):
    """One tower block: norm1, q/k/v/o, norm2 and the MLP (gate is None
    for an ungated MLP)."""

    def __init__(self, norm1, q, k, v, o, norm2, gate, up, down):
        super().__init__()
        self.norm1, self.q, self.k, self.v, self.o = norm1, q, k, v, o
        self.norm2, self.gate, self.up, self.down = norm2, gate, up, down


def _vnorm(x: torch.Tensor, w: NormWeights, kind: str, eps: float):
    """RMS or LayerNorm in f32, returned in x's dtype."""
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * w.weight.float()
    if w.bias is not None:
        y = y + w.bias.float()
    return y.to(x.dtype)


def _vact(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return Fn.silu(x)
    if kind in ("gelu", "gelu_pytorch_tanh"):
        return Fn.gelu(x, approximate="tanh")
    if kind == "quickgelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(kind)


def _dense(x: torch.Tensor, lin) -> torch.Tensor:
    """x rounded to bf16 @ the bf16 weight -> f32, plus the bias."""
    return linear_apply(x.to(torch.bfloat16), lin)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [H, M, K] @ b [H, K, N] -> f32: one bf16 x bf16 batched product
    with an f32 result on the card, the f32 product on the CPU (the
    operands are bf16 values either way)."""
    if not a.is_cuda:
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                     out_dtype=torch.float32)


def _rope2d(x: torch.Tensor, sin, cos) -> torch.Tensor:
    """Rotary with full-width tables [S, D] (the cat(freqs, freqs) layout
    of the pixtral and qwen2 towers: NEOX halves)."""
    if sin is None:
        return x
    d = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    s1 = sin[:, None, : d // 2]
    c1 = cos[:, None, : d // 2]
    out = torch.cat([x1 * c1 - x2 * s1, x2 * c1 + x1 * s1], dim=-1)
    return out.to(x.dtype)


def _load_patch_conv(tfm, key: str, device):
    """Patch conv as a flattened linear: weight [Cout, Cin, (T,) H, W] ->
    [Cin * prod(patch), Cout]."""
    w = read_weight_f32(tfm, key + ".weight")
    w2 = w.reshape(w.shape[0], -1).T
    b = read_weight_f32(tfm, key + ".bias") if key + ".bias" in tfm else None
    return from_dense(w2, b, device=device)


def _load_parts(cfg: ModelConfig, device) -> dict:
    """The tower's modules from the checkpoint of `cfg`."""
    tfm = cfg.tensor_file_map
    arch = cfg.arch
    vt = cfg.vision_model_type
    pre = arch.vt_prefix

    def lin(key):
        return load_linear(tfm, key, device=device)

    def norm(key):
        return load_norm(tfm, key, device=device)

    ln_pre = pos_emb = None
    if vt == "pixtral":
        keys = dict(layers="transformer.layers", attn=".attention",
                    q=".q_proj", k=".k_proj", v=".v_proj", o=".o_proj",
                    norm1=".attention_norm", norm2=".ffn_norm",
                    gate=".feed_forward.gate_proj",
                    up=".feed_forward.up_proj",
                    down=".feed_forward.down_proj")
        ln_pre = norm(pre + "ln_pre")
        patch_conv = _load_patch_conv(tfm, pre + "patch_conv", device)
    elif vt in ("qwen2", "qwen2.5"):
        q25 = vt == "qwen2.5"
        keys = dict(layers="blocks", attn=".attn", fused_qkv=".qkv",
                    o=".proj", norm1=".norm1", norm2=".norm2",
                    gate=".mlp.gate_proj" if q25 else None,
                    up=".mlp.up_proj" if q25 else ".mlp.fc1",
                    down=".mlp.down_proj" if q25 else ".mlp.fc2")
        patch_conv = _load_patch_conv(tfm, pre + "patch_embed.proj", device)
    else:                                       # siglip (Gemma 3)
        keys = dict(layers="encoder.layers", attn=".self_attn",
                    q=".q_proj", k=".k_proj", v=".v_proj", o=".out_proj",
                    norm1=".layer_norm1", norm2=".layer_norm2", gate=None,
                    up=".mlp.fc1", down=".mlp.fc2")
        patch_conv = _load_patch_conv(
            tfm, pre + "embeddings.patch_embedding", device)
        pos_emb = torch.from_numpy(np.ascontiguousarray(read_weight_f32(
            tfm, pre + "embeddings.position_embedding.weight"))).to(
            device).to(torch.bfloat16)

    layers = []
    for l in range(cfg.vision_num_layers):
        base = pre + keys["layers"] + f".{l}"
        if "fused_qkv" in keys:
            fused = lin(base + keys["attn"] + keys["fused_qkv"])
            w = cfg.vision_num_attention_heads * cfg.vision_head_dim
            q, k, v = (slice_columns(fused, i * w, (i + 1) * w)
                       for i in range(3))
        else:
            q, k, v = (lin(base + keys["attn"] + keys[n])
                       for n in ("q", "k", "v"))
        layers.append(_VLayer(
            norm(base + keys["norm1"]), q, k, v,
            lin(base + keys["attn"] + keys["o"]), norm(base + keys["norm2"]),
            lin(base + keys["gate"]) if keys.get("gate") else None,
            lin(base + keys["up"]), lin(base + keys["down"])))

    mp = arch.mmp_prefix
    if vt == "pixtral":
        mmp = dict(kind="mlp", act="gelu", norm_kind="rms",
                   norm=norm(mp + "norm") if mp + "norm.weight" in tfm
                   else None,
                   patch_merger=lin(mp + "patch_merger.merging_layer")
                   if mp + "patch_merger.merging_layer.weight" in tfm
                   else None,
                   up=lin(mp + "linear_1"), down=lin(mp + "linear_2"))
    elif vt in ("qwen2", "qwen2.5"):
        # qwen2.5's ln_q is an RMSNorm, qwen2's a LayerNorm
        mmp = dict(kind="mlp", act="gelu",
                   norm_kind="rms" if vt == "qwen2.5" else "layernorm",
                   norm=norm(mp + "ln_q"), patch_merger=None,
                   up=lin(mp + "mlp.0"), down=lin(mp + "mlp.2"))
    else:
        # soft-embedding norm and input projection (after an average pool)
        proj_key = mp + "mm_input_projection"
        proj = None
        if proj_key + ".weight" in tfm:
            w = read_weight_f32(tfm, proj_key + ".weight")
            # stored [vision_hidden, lm_hidden] already (google keymap)
            if w.shape[0] != cfg.vision_hidden_size:
                w = w.T
            proj = from_dense(w, device=device)
        mmp = dict(kind="proj", norm=norm(mp + "mm_soft_emb_norm"),
                   proj=proj)
    return dict(layers=layers, patch_conv=patch_conv, ln_pre=ln_pre,
                pos_emb=pos_emb, mmp=mmp)


class VisionTower(nn.Module):
    """The vision stack of a multimodal checkpoint on `device` (the card
    by default). `parts` (layers, patch_conv, ln_pre, pos_emb and the
    projector dict mmp, as _load_parts returns them) builds it from
    weights in memory instead of the checkpoint of `cfg`."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 parts: dict | None = None):
        super().__init__()
        assert cfg.vision_model_type, "config has no vision tower"
        self.cfg = cfg
        self.vt = vt = cfg.vision_model_type
        self.norm_kind = "rms" if vt in ("pixtral", "qwen2.5") \
            else "layernorm"
        self.eps = 1e-6
        if parts is None:
            parts = _load_parts(cfg, resolve_device(device))
        self.layers = nn.ModuleList(parts["layers"])
        self.patch_conv = parts["patch_conv"]
        self.ln_pre = parts["ln_pre"]
        self.register_buffer("pos_emb", parts["pos_emb"])
        mmp = parts["mmp"]
        self.mmp_kind = mmp["kind"]
        self.mmp_act = mmp.get("act")
        self.mmp_norm_kind = mmp.get("norm_kind")
        self.mmp_norm = mmp["norm"]
        self.mmp_patch_merger = mmp.get("patch_merger")
        self.mmp_up = mmp.get("up")
        self.mmp_down = mmp.get("down")
        self.mmp_proj = mmp.get("proj")

    @property
    def device(self) -> torch.device:
        """Where the weights are (``.to()`` moves the whole tower)."""
        return self.patch_conv.weight.device

    # ------------------------------------------------------------------

    def _rope_tables(self, p_h: int, p_w: int, thw=None):
        """Host-built rotary tables for an image grid -> (sin, cos) [S,
        head_dim] f32 on the device, or (None, None) (siglip: learned
        positions)."""
        cfg = self.cfg
        hd = cfg.vision_head_dim
        if self.vt == "pixtral":
            freqs = 1.0 / (cfg.vision_rope_theta
                           ** (np.arange(0, hd, 2) / hd))
            fh = np.outer(np.arange(p_h), freqs[::2])
            fw = np.outer(np.arange(p_w), freqs[1::2])
            inv = np.concatenate([
                np.repeat(fh[:, None, :], p_w, axis=1),
                np.repeat(fw[None, :, :], p_h, axis=0),
            ], axis=-1).reshape(-1, hd // 2)
            emb = np.concatenate([inv, inv], axis=-1)
        elif self.vt in ("qwen2", "qwen2.5"):
            t, h, w = thw if thw is not None else (1, p_h, p_w)
            spm = cfg.vision_spatial_merge_size
            dim = hd // 2
            freqs = 1.0 / (cfg.vision_rope_theta
                           ** (np.arange(0, dim, 2) / dim))
            hpos = np.arange(h)[:, None].repeat(w, 1)
            hpos = hpos.reshape(h // spm, spm, w // spm, spm)
            hpos = hpos.transpose(0, 2, 1, 3).reshape(-1)
            wpos = np.arange(w)[None, :].repeat(h, 0)
            wpos = wpos.reshape(h // spm, spm, w // spm, spm)
            wpos = wpos.transpose(0, 2, 1, 3).reshape(-1)
            emb = np.concatenate([hpos[:, None] * freqs[None, :],
                                  wpos[:, None] * freqs[None, :]], axis=-1)
            emb = np.tile(emb, (t, 1))
            emb = np.concatenate([emb, emb], axis=-1)       # [S, hd]
        else:
            return None, None

        def dev(a):
            return torch.from_numpy(a.astype(np.float32)).to(self.device)
        return dev(np.sin(emb)), dev(np.cos(emb))

    def _window_order(self, thw):
        """qwen2.5's window attention: the merged units in window order and
        the window bounds in patches -> (order [S / merge^2], cu_seqlens)."""
        cfg = self.cfg
        t, h, w = thw
        spm = cfg.vision_spatial_merge_size
        vms = (cfg.vision_window_size // spm
               // cfg.vision_patch_size["height"])
        lh, lw = h // spm, w // spm
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % vms, (-lw) % vms
        nh, nw = (lh + pad_h) // vms, (lw + pad_w) // vms
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, idx.dtype)
        padded[:, :lh, :lw] = idx
        padded = padded.reshape(t, nh, vms, nw, vms)
        padded = padded.transpose(0, 1, 3, 2, 4).reshape(t, nh * nw,
                                                         vms, vms)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        order = flat[flat != -100]
        cu = np.concatenate([[0], np.cumsum(seqlens) * spm ** 2])
        return order, np.unique(cu)

    def _forward_tower(self, x, sin, cos, block_cu=None, full_layers=()):
        """patches [S, d_v] bf16 -> [S, d_v] bf16 through every block."""
        cfg = self.cfg
        nh = cfg.vision_num_attention_heads
        nkv = cfg.vision_num_key_value_heads
        hd = cfg.vision_head_dim
        s = x.shape[0]
        win = None
        if block_cu is not None:
            seg = np.zeros(s, np.int32)
            seg[block_cu[:-1]] = 1
            seg = torch.from_numpy(np.cumsum(seg)).to(self.device)
            win = seg[:, None] == seg[None, :]
        for li, lw in enumerate(self.layers):
            h = _vnorm(x, lw.norm1, self.norm_kind, self.eps)
            q = _rope2d(_dense(h, lw.q).reshape(s, nh, hd), sin, cos)
            k = _rope2d(_dense(h, lw.k).reshape(s, nkv, hd), sin, cos)
            v = _dense(h, lw.v).reshape(s, nkv, hd)
            qb = q.to(torch.bfloat16).transpose(0, 1)            # [H, S, D]
            kb = k.to(torch.bfloat16).permute(1, 2, 0)           # [H, D, S]
            scores = _bmm(qb, kb) * (hd ** -0.5)                 # [H, S, S]
            if win is not None and li not in full_layers:
                scores = scores.masked_fill(~win[None], _NEG)
            probs = torch.softmax(scores, dim=-1).to(torch.bfloat16)
            del scores
            att = _bmm(probs, v.to(torch.bfloat16).transpose(0, 1))
            att = att.transpose(0, 1).reshape(s, nh * hd)
            o = _dense(att.to(torch.bfloat16), lw.o)
            x = x + o.to(x.dtype)

            h2 = _vnorm(x, lw.norm2, self.norm_kind, self.eps)
            up = _dense(h2, lw.up)
            if lw.gate is not None:
                inter = _vact(_dense(h2, lw.gate), cfg.vision_hidden_act) * up
            else:
                inter = _vact(up, cfg.vision_hidden_act)
            x = x + _dense(inter.to(torch.bfloat16), lw.down).to(x.dtype)
        return x

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        """Tower output [S, d_v] bf16 -> LM embedding rows [S', d_lm] f32."""
        cfg = self.cfg
        if self.mmp_kind == "proj":                       # Gemma 3
            s, dv = x.shape
            patches = int(round(s ** 0.5))
            tokens_side = int(cfg.vision_mm_tokens_per_image ** 0.5)
            ksz = max(patches // max(tokens_side, 1), 1)
            xs = x.reshape(patches // ksz, ksz, patches // ksz, ksz, dv)
            pooled = xs.float().mean(dim=(1, 3)).to(x.dtype).reshape(-1, dv)
            h = _vnorm(pooled, self.mmp_norm, "rms", self.eps)
            if self.mmp_proj is not None:
                h = _dot(h.to(torch.bfloat16), self.mmp_proj.weight)
            return h
        # the mlp merger (pixtral, qwen2, Mistral 3): its norm (ln_q) takes
        # each patch's features BEFORE the spatial-merge concat
        if self.mmp_norm is not None:
            x = _vnorm(x, self.mmp_norm, self.mmp_norm_kind, self.eps)
        merge = cfg.vision_spatial_merge_size ** 2
        if merge > 1:
            x = x.reshape(x.shape[0] // merge, merge * x.shape[1])
        if self.mmp_patch_merger is not None:
            x = _dense(x, self.mmp_patch_merger)
        h = _vact(_dense(x, self.mmp_up), self.mmp_act)
        return _dense(h, self.mmp_down)

    @torch.no_grad()
    def process(self, pixels, patches_size=None, thw_grid=None):
        """Preprocessed pixels (numpy, processing.preprocess) -> LM-space
        embedding rows [S', d_lm] f32 on the tower's device."""
        cfg = self.cfg
        if self.vt in ("qwen2", "qwen2.5"):
            px = np.asarray(pixels, np.float32)
            _, p_h, p_w = thw_grid
        else:
            px = np.asarray(pixels, np.float32)
            c, ih, iw = px.shape
            ph = cfg.vision_patch_size["height"]
            pw = cfg.vision_patch_size["width"]
            p_h, p_w = ih // ph, iw // pw
            # stride == kernel conv -> patch flatten + product
            px = px.reshape(c, p_h, ph, p_w, pw)
            px = px.transpose(1, 3, 0, 2, 4).reshape(p_h * p_w, c * ph * pw)
        patches = torch.from_numpy(np.ascontiguousarray(px)).to(
            self.device).to(torch.bfloat16)

        x = _dense(patches, self.patch_conv).to(torch.bfloat16)
        if self.ln_pre is not None:
            x = _vnorm(x, self.ln_pre, "rms", self.eps)
        if self.pos_emb is not None:
            x = x + self.pos_emb[:x.shape[0]]

        sin, cos = self._rope_tables(p_h, p_w, thw_grid)
        block_cu, full_layers, order = None, (), None
        if self.vt == "qwen2.5" and cfg.vision_window_size:
            order, block_cu = self._window_order(thw_grid)
            unit = cfg.vision_spatial_merge_size ** 2
            s = x.shape[0]
            perm = torch.from_numpy(order).to(self.device)

            def reorder(a):
                return a.reshape(s // unit, unit, -1)[perm].reshape(s, -1)
            x = reorder(x)
            if sin is not None:
                sin, cos = reorder(sin), reorder(cos)
            full_layers = tuple(cfg.vision_fullatt_block_indexes or ())

        x = self._forward_tower(x, sin, cos, block_cu, full_layers)
        out = self._project(x.to(torch.bfloat16))
        if order is not None:
            out = out[torch.from_numpy(np.argsort(order)).to(self.device)]
        return out

    # ------------------------------------------------------------------

    def _embed(self, model, tokenizer, frames, text_alias, video: bool):
        cfg = self.cfg
        pixels, new_size, thw = processing.preprocess(cfg, frames)
        fx = new_size[0] // cfg.vision_patch_size["width"]
        fy = new_size[1] // cfg.vision_patch_size["height"]
        emb = self.process(pixels, (fy, fx), thw)
        emb, pre, post = processing.postprocess(
            cfg, model.weights, tokenizer, emb, fy, fx)
        mme = MMEmbedding(emb, text_alias=text_alias,
                          thw_grid=thw if video else (thw or (1, fy, fx)),
                          pre_tokens=pre, post_tokens=post)
        mme.metadata.update({"preprocessed_size": new_size,
                             "patches_size": (fy, fx)})
        return mme

    def get_image_embeddings(self, model, tokenizer, image,
                             text_alias: str | None = None) -> MMEmbedding:
        """Image (PIL or [H, W, 3] array) -> MMEmbedding for the dynamic
        generator, on the tower's device."""
        return self._embed(model, tokenizer, image, text_alias, False)

    def get_video_embeddings(self, model, tokenizer, video,
                             text_alias: str | None = None) -> MMEmbedding:
        """Video (a list of frames) -> MMEmbedding (qwen2 towers only)."""
        assert self.vt in ("qwen2", "qwen2.5"), \
            "video embeddings require a qwen2-family tower"
        return self._embed(model, tokenizer, list(video), text_alias, True)
