"""Image preprocessing per vision-tower family (PyTorch port of
exllamav2_tpu/vlm/processing.py).

Resize rules, normalization and qwen2's patch flattening run in numpy, as
in the reference (the same arrays bit for bit); the decoration of a tower's
output with marker-token rows ([IMG_BREAK] / [IMG_END], vision_start /
vision_end, start_of_image / end_of_image) joins device tensors. Images may
be PIL Images or numpy [H, W, 3] uint8 / float arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["preprocess", "postprocess", "smart_resize",
           "size_to_longest_edge_and_patch_size"]


def _to_array(image, size=None, resample: int = 3) -> np.ndarray:
    """PIL Image | ndarray -> float32 [H, W, 3], optionally resized."""
    try:
        from PIL import Image as PILImage
        is_pil = not isinstance(image, np.ndarray)
    except ImportError:
        PILImage, is_pil = None, False
    if is_pil:
        if image.mode != "RGB":
            # transparent regions composite onto white (vlm/util.py:7-19)
            rgba = image.convert("RGBA")
            bg = PILImage.new("RGBA", image.size, "WHITE")
            bg.paste(rgba, (0, 0), rgba)
            image = bg.convert("RGB")
        if size is not None and image.size != size:
            image = image.resize(size, resample=PILImage.Resampling(resample))
        return np.asarray(image).astype(np.float32)
    arr = np.asarray(image).astype(np.float32)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if size is not None and (arr.shape[1], arr.shape[0]) != size:
        arr = _resize_bilinear(arr, size[1], size[0])
    return arr


def _resize_bilinear(arr: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Minimal bilinear resize for array inputs (no PIL dependency)."""
    h, w = arr.shape[:2]
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = arr[y0][:, x0]
    b = arr[y0][:, x1]
    c = arr[y1][:, x0]
    d = arr[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def _normalize(image: np.ndarray, mean, std, rescale: float) -> np.ndarray:
    image = image * rescale
    return (image - np.asarray(mean, np.float32)) / \
        np.asarray(std, np.float32)


def size_to_longest_edge_and_patch_size(input_size, max_size, patch_size):
    """Aspect-preserving fit into max_size, rounded up to patch multiples
    (vlm/util.py:22-46). Sizes are (width, height) PIL-style."""
    ratio = max(input_size[0] / max_size[0], input_size[1] / max_size[1])
    if ratio > 1:
        out = tuple(max(1, int(np.floor(d / ratio))) for d in input_size)
    else:
        out = input_size
    return tuple(((d + p - 1) // p) * p for d, p in zip(out, patch_size))


def smart_resize(size, factor=28, min_pixels=56 * 56,
                 max_pixels=14 * 14 * 4 * 1280):
    """Qwen2-VL resize rule (vlm/util.py:73-105). size = (w, h)."""
    width, height = size
    if height < factor or width < factor:
        raise ValueError(f"image {width}x{height} smaller than {factor}")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return (w_bar, h_bar)


def preprocess(cfg, images):
    """-> (pixel tensor, (w, h), thw_grid | None).

    pixtral/siglip: [3, H, W] image; qwen2/2.5: flattened patch rows
    [S, C*tps*p*p] (processor/qwen2.py:63-92).
    """
    vt = cfg.vision_model_type
    if vt == "pixtral":
        img = images if not isinstance(images, list) else images[0]
        p2 = tuple(cfg.vision_patch_size[d] * 2 for d in ("width", "height"))
        longest = cfg.vision_size.get("longest_edge", 1024)
        arr0 = _to_array(img)
        old = (arr0.shape[1], arr0.shape[0])
        new = size_to_longest_edge_and_patch_size(
            old, (longest, longest), p2)
        arr = _to_array(img, size=new, resample=cfg.vision_resample)
        arr = _normalize(arr, cfg.vision_image_mean, cfg.vision_image_std,
                         cfg.vision_rescale_factor)
        return arr.transpose(2, 0, 1), new, None
    if vt == "siglip_vision_model":
        new = (cfg.vision_size["width"], cfg.vision_size["height"])
        img = images if not isinstance(images, list) else images[0]
        arr = _to_array(img, size=new, resample=cfg.vision_resample)
        arr = _normalize(arr, cfg.vision_image_mean, cfg.vision_image_std,
                         cfg.vision_rescale_factor)
        return arr.transpose(2, 0, 1), new, None
    if vt in ("qwen2", "qwen2.5"):
        frames = images if isinstance(images, list) else [images]
        g = cfg.vision_temporal_patch_size
        if len(frames) > 1:
            frames = frames[:len(frames) // g * g]
        arr0 = _to_array(frames[0])
        old = (arr0.shape[1], arr0.shape[0])
        new = smart_resize(
            old,
            cfg.vision_spatial_patch_size * cfg.vision_spatial_merge_size,
            cfg.vision_min_pixels, cfg.vision_max_pixels)
        arrs = [_normalize(_to_array(f, size=new,
                                     resample=cfg.vision_resample),
                           cfg.vision_image_mean, cfg.vision_image_std,
                           cfg.vision_rescale_factor) for f in frames]
        patches = np.stack(arrs).transpose(0, 3, 1, 2)   # [F, C, H, W]
        if patches.shape[0] == 1:
            patches = np.tile(patches, (g, 1, 1, 1))
        channels = patches.shape[1]
        sp = cfg.vision_spatial_patch_size
        sm = cfg.vision_spatial_merge_size
        grid_t = patches.shape[0] // g
        grid_h = new[1] // sp
        grid_w = new[0] // sp
        patches = patches.reshape(
            grid_t, g, channels, grid_h // sm, sm, sp, grid_w // sm, sm, sp)
        patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
        flat = patches.reshape(grid_t * grid_h * grid_w,
                               channels * g * sp * sp)
        return flat, new, (grid_t, grid_h, grid_w)
    raise ValueError(f"unknown vision model type {vt!r}")


def postprocess(cfg, model_weights, tokenizer, embeddings,
                features_y: int, features_x: int):
    """Decorate tower output [n, d] (a device tensor) with marker-token
    embedding rows, taken unscaled from the embedding table.

    -> (embeddings f32, pre_tokens, post_tokens). pixtral: an [IMG_BREAK]
    row after each feature row and an [IMG_END] row; qwen2 / siglip:
    vision_start / vision_end or start / end_of_image around the block.
    """
    def tok_row(piece):
        tid = tokenizer.piece_to_id(piece)
        if tid is None:
            return None
        return model_weights.embed[tid][None, :].float()

    embeddings = embeddings.float()
    vt = cfg.vision_model_type
    if vt == "pixtral":
        fx = features_x // cfg.vision_spatial_merge_size
        fy = features_y // cfg.vision_spatial_merge_size
        dim = embeddings.shape[-1]
        brk = tok_row("[IMG_BREAK]")
        end = tok_row("[IMG_END]")
        emb = embeddings.reshape(fy, fx, dim)
        if brk is not None:
            col = brk.reshape(1, 1, dim).expand(fy, 1, dim)
            emb = torch.cat([emb, col], dim=1)
        emb = emb.reshape(-1, dim)
        if end is not None:
            emb = torch.cat([emb, end], dim=0)
        return emb, 0, 0
    if vt in ("qwen2", "qwen2.5"):
        start = tok_row("<|vision_start|>")
        end = tok_row("<|vision_end|>")
    else:
        start = tok_row("<start_of_image>")
        end = tok_row("<end_of_image>")
    pre = post = 0
    parts = [embeddings]
    if start is not None:
        parts.insert(0, start)
        pre = 1
    if end is not None:
        parts.append(end)
        post = 1
    return torch.cat(parts, dim=0), pre, post
