"""Color pipeline: gamma and u8 quantization (twin of
`raytracing_tpu.ops.color`)."""

from __future__ import annotations

import numpy as np
import torch


def gamma_correct(rgb: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Per-channel pow(1/gamma), evaluated at max(rgb, 1e-6); exact zeros
    (and negatives) map to 0."""
    y = torch.pow(torch.clamp_min(rgb, 1e-6), 1.0 / gamma)
    return torch.where(rgb <= 0.0, torch.zeros_like(y), y)


def to_u8(rgb) -> torch.Tensor:
    """Float RGB (a tensor on any device, or an array) -> u8 on the same
    device: scale by 255 in f32, min with 255, truncate toward zero — the
    JAX package's values. Negatives and NaN give 0, as XLA's conversion
    gives them; a bare `.to(torch.uint8)` would wrap -25.5 to 231."""
    x = torch.as_tensor(rgb, dtype=torch.float32) * 255.0
    x = torch.nan_to_num(x, nan=0.0).clamp(0.0, 255.0)
    return x.to(torch.uint8)


def to_rgba_frame(rgb) -> np.ndarray:
    """[H, W, 3] float -> [H, W, 4] u8 RGBA on the host, alpha 0xff. The
    quantization runs where the image is; only the u8 frame is copied."""
    rgb8 = to_u8(rgb).cpu().numpy()
    frame = np.empty(rgb8.shape[:-1] + (4,), dtype=np.uint8)
    frame[..., :3] = rgb8
    frame[..., 3] = 0xFF
    return frame
