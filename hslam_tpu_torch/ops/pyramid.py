"""Direct image pyramid: per level [I, dx, dy] and |grad|^2 (port of
hslam_tpu/ops/pyramid.py).

`build_direct_pyramid` is the per-frame entry. For a CUDA tensor every
level is one launch of the hand-written kernel in csrc/pyramid.cu (which
replaces the JAX package's Pallas `_level_kernel`); a failed build or
launch raises. For a CPU tensor, and only there, the plain torch version
below runs. `kernel_launches` and `plain_calls` count the two routes.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

kernel_launches = 0     # CUDA kernel launches (one per pyramid level)
plain_calls = 0         # plain-torch pyramid builds (one per pyramid)

_fn = None


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling; an odd trailing row/col is dropped. Summed in
    the kernel's order, 0.25 * ((a + b) + (c + d)), so both routes give the
    same bits: the gamma-LUT index truncates the level intensity, and one
    ulp across an integer would change the bin."""
    H, W = img.shape
    img = img[: (H // 2) * 2, : (W // 2) * 2]
    return 0.25 * ((img[0::2, 0::2] + img[0::2, 1::2])
                   + (img[1::2, 0::2] + img[1::2, 1::2]))


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences 0.5*(I[x+1]-I[x-1]), zero on the border."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return dx, dy


def build_direct_pyramid_plain(image: torch.Tensor, n_levels: int,
                               gamma_grad_weight: Optional[torch.Tensor] = None):
    """The plain torch pyramid (pyramid.py:99-113 of the JAX package)."""
    levels, grads = [], []
    img = image
    for lvl in range(n_levels):
        if lvl > 0:
            img = downsample2(img)
        dx, dy = image_gradients(img)
        g2 = dx * dx + dy * dy
        if gamma_grad_weight is not None:
            idx = torch.clamp(img.to(torch.int32), 0, 255).long()
            gw = gamma_grad_weight[idx]
            g2 = g2 * gw * gw
        levels.append(torch.stack([img, dx, dy], dim=-1))
        grads.append(g2)
    return levels, grads


_BLUR7 = (0.070766, 0.131305, 0.190776, 0.214305, 0.190776, 0.131305, 0.070766)


def gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    """7x7 sigma=2 separable Gaussian with edge padding (cv::GaussianBlur
    (7, 7, 2, 2) before rBRIEF sampling), summed tap by tap in the JAX
    package's order."""
    k = torch.tensor(_BLUR7, dtype=img.dtype, device=img.device)
    k = k / k.sum()
    H, W = img.shape
    padded = torch.cat([img[:1].expand(3, W), img, img[-1:].expand(3, W)], dim=0)
    out = torch.zeros_like(img)
    for i in range(7):
        out = out + padded[i:i + H] * k[i]
    padded = torch.cat([out[:, :1].expand(H, 3), out, out[:, -1:].expand(H, 3)], dim=1)
    out2 = torch.zeros_like(img)
    for i in range(7):
        out2 = out2 + padded[:, i:i + W] * k[i]
    return out2


def _kernel():
    global _fn
    if _fn is None:
        from .. import _cuda

        fn = _cuda.load("pyramid").hslam_pyramid_level
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def build_direct_pyramid_cuda(image: torch.Tensor, n_levels: int,
                              gamma_grad_weight: Optional[torch.Tensor] = None):
    """One kernel launch per level on the current stream."""
    global kernel_launches
    if image.device.type != "cuda" or image.dtype != torch.float32 or image.dim() != 2:
        raise ValueError("build_direct_pyramid_cuda takes a 2-D float32 CUDA "
                         f"tensor, got {image.dtype} {tuple(image.shape)} on "
                         f"{image.device}")
    gw_ptr = None
    if gamma_grad_weight is not None:
        gw = gamma_grad_weight
        if (gw.device != image.device or gw.dtype != torch.float32
                or gw.shape != (256,) or not gw.is_contiguous()):
            raise ValueError("gamma_grad_weight must be a contiguous (256,) "
                             "float32 tensor on the image's device")
        gw_ptr = gw.data_ptr()
    fn = _kernel()
    stream = torch.cuda.current_stream(image.device).cuda_stream
    img = image.contiguous()
    levels, grads = [], []
    for _ in range(n_levels):
        H, W = img.shape
        if H < 1 or W < 1:
            raise ValueError(f"pyramid level of size {H}x{W}: too many levels "
                             "for the image")
        out3 = torch.empty((H, W, 3), dtype=torch.float32, device=img.device)
        g2 = torch.empty((H, W), dtype=torch.float32, device=img.device)
        down = torch.empty((H // 2, W // 2), dtype=torch.float32, device=img.device)
        err = fn(img.data_ptr(), out3.data_ptr(), g2.data_ptr(),
                 down.data_ptr(), gw_ptr, H, W, stream)
        if err != 0:
            raise RuntimeError(f"pyramid kernel launch failed: cudaError {err}")
        kernel_launches += 1
        levels.append(out3)
        grads.append(g2)
        img = down
    return levels, grads


def build_direct_pyramid(
    image: torch.Tensor,
    n_levels: int,
    gamma_grad_weight: Optional[torch.Tensor] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(pyr, abs_grad2): pyr[l] is (H_l, W_l, 3) [I, dx, dy], abs_grad2[l]
    the (H_l, W_l) squared gradient magnitude. uint8 input is cast to f32
    first. CUDA tensors go through the kernel (or raise); CPU tensors
    through the plain version."""
    global plain_calls
    image = image.to(torch.float32)
    if image.device.type == "cuda":
        return build_direct_pyramid_cuda(image, n_levels, gamma_grad_weight)
    if image.device.type != "cpu":
        raise ValueError(f"no pyramid route for device {image.device}")
    plain_calls += 1
    return build_direct_pyramid_plain(image, n_levels, gamma_grad_weight)
