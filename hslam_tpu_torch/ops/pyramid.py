"""Direct image pyramid: per level [I, dx, dy] and |grad|^2 (port of
hslam_tpu/ops/pyramid.py).

`build_direct_pyramid` is the per-frame entry. For a CUDA tensor the whole
pyramid is one launch of the hand-written kernel in csrc/pyramid.cu (which
replaces the JAX package's Pallas `_level_kernel`); a failed build or
launch raises. For a CPU tensor, and only there, the plain torch version
below runs. `kernel_launches` and `plain_calls` count the two routes.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, NamedTuple, Optional, Tuple

import torch

kernel_launches = 0     # launches of the fused kernel (one per pyramid)
plain_calls = 0         # plain-torch pyramid builds (one per pyramid)
per_level_launches = 0  # launches of the per-level yardstick kernel

MAX_LEVELS = 8          # the kernel takes its offsets as fixed-size arrays
_ALIGN = 4              # floats: every level's sub-buffer starts on 16 bytes

_fns = None
_counters: dict = {}    # (device index, stream) -> the kernel's int32 block counter
_launch_lock = threading.Lock()


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


class PyramidLayout(NamedTuple):
    """Where every level lies in the kernel's one flat float32 buffer."""
    shapes: Tuple[Tuple[int, int], ...]   # (H_l, W_l)
    off3: Tuple[int, ...]                 # float offset of level l's (H_l, W_l, 3)
    offg: Tuple[int, ...]                 # float offset of level l's (H_l, W_l) g2
    total: int                            # floats in the buffer


@functools.lru_cache(maxsize=64)
def pyramid_layout(H: int, W: int, n_levels: int) -> PyramidLayout:
    """Level l is (H >> l, W >> l); its [I, dx, dy] and then its g2 follow
    the level before, each starting on a multiple of 16 bytes."""
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"n_levels must be 1..{MAX_LEVELS}, got {n_levels}")
    shapes, off3, offg, pos = [], [], [], 0
    for lvl in range(n_levels):
        h, w = H >> lvl, W >> lvl
        if h < 1 or w < 1:
            raise ValueError(f"pyramid level {lvl} of a {H}x{W} image has size "
                             f"{h}x{w}: too many levels for the image")
        shapes.append((h, w))
        for offs, size in ((off3, 3 * h * w), (offg, h * w)):
            offs.append(pos)
            pos += -(-size // _ALIGN) * _ALIGN
    return PyramidLayout(tuple(shapes), tuple(off3), tuple(offg), pos)


@functools.lru_cache(maxsize=64)
def _layout_args(H: int, W: int, n_levels: int):
    """The layout with its offsets as the C arrays the kernel's entry takes."""
    lay = pyramid_layout(H, W, n_levels)
    pad = (0,) * (MAX_LEVELS - n_levels)
    arr = ctypes.c_longlong * MAX_LEVELS
    return lay, arr(*lay.off3, *pad), arr(*lay.offg, *pad)


def _kernels():
    """(fused, per_level): the two C entries of csrc/pyramid.cu."""
    global _fns
    if _fns is None:
        from .. import _cuda

        lib = _cuda.load("pyramid")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fused = lib.hslam_pyramid_fused
        fused.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci, vp, vp, vp]
        fused.restype = ci
        level = lib.hslam_pyramid_level
        level.argtypes = [vp] * 5 + [ci, ci, vp]
        level.restype = ci
        _fns = (fused, level)
    return _fns


def _check_cuda_inputs(image: torch.Tensor, gamma_grad_weight):
    """Raises on what the kernels do not take; the gamma weight's pointer."""
    if (image.device.type != "cuda" or image.dtype not in (torch.uint8, torch.float32)
            or image.dim() != 2):
        raise ValueError("the pyramid kernel takes a 2-D uint8 or float32 CUDA tensor, "
                         f"got {image.dtype} {tuple(image.shape)} on {image.device}")
    if gamma_grad_weight is None:
        return None
    gw = gamma_grad_weight
    if (gw.device != image.device or gw.dtype != torch.float32
            or gw.shape != (256,) or not gw.is_contiguous()):
        raise ValueError("gamma_grad_weight must be a contiguous (256,) "
                         "float32 tensor on the image's device")
    return gw.data_ptr()


def pyramid_views(buf: torch.Tensor, layout: PyramidLayout):
    """(pyr, abs_grad2) as contiguous views of the flat buffer."""
    levels = [torch.as_strided(buf, (h, w, 3), (3 * w, 3, 1), o)
              for (h, w), o in zip(layout.shapes, layout.off3)]
    grads = [torch.as_strided(buf, (h, w), (w, 1), o)
             for (h, w), o in zip(layout.shapes, layout.offg)]
    return levels, grads


def _launch(image: torch.Tensor, buf: torch.Tensor, n_levels: int, gw_ptr) -> None:
    """The fused kernel on the current stream; the arguments are checked."""
    global kernel_launches
    H, W = image.shape
    _, c_off3, c_offg = _layout_args(H, W, n_levels)
    fused, _ = _kernels()
    stream = torch.cuda.current_stream(image.device).cuda_stream
    key = (image.device.index, stream)
    with _launch_lock:
        counter = _counters.get(key)
        if counter is None:
            counter = _counters[key] = torch.zeros(1, dtype=torch.int32, device=image.device)
        err = fused(image.data_ptr(), int(image.dtype == torch.uint8), buf.data_ptr(),
                    c_off3, c_offg, n_levels, H, W, gw_ptr, counter.data_ptr(), stream)
        if err != 0:
            # the kernel may have left its counter dirty: the next call makes a new one
            del _counters[key]
            raise RuntimeError(f"pyramid kernel launch failed: cudaError {err}")
        kernel_launches += 1


def launch_pyramid(image: torch.Tensor, buf: torch.Tensor, n_levels: int,
                   gamma_grad_weight: Optional[torch.Tensor] = None) -> PyramidLayout:
    """One launch of the fused kernel into a buffer the caller keeps: the
    pyramid of `image` (2-D uint8 or float32, contiguous, CUDA) goes into
    `buf`, a flat float32 buffer of at least `pyramid_layout(...).total`
    elements, where `pyramid_views` finds the levels."""
    gw_ptr = _check_cuda_inputs(image, gamma_grad_weight)
    lay = pyramid_layout(image.shape[0], image.shape[1], n_levels)
    if (buf.device != image.device or buf.dtype != torch.float32 or buf.dim() != 1
            or buf.numel() < lay.total or not buf.is_contiguous()
            or buf.data_ptr() % (4 * _ALIGN) or not image.is_contiguous()):
        raise ValueError("launch_pyramid needs a contiguous image and a flat, 16-byte "
                         f"aligned float32 buffer of {lay.total} elements on its device")
    _launch(image, buf, n_levels, gw_ptr)
    return lay


def build_direct_pyramid_cuda(image: torch.Tensor, n_levels: int,
                              gamma_grad_weight: Optional[torch.Tensor] = None):
    """The whole pyramid of a uint8 or float32 CUDA image in one kernel
    launch on the current stream. All levels are views of one flat buffer
    (one allocation), so any level that is still referenced keeps the whole
    buffer alive (~6.6 MB at 480x640); the window copies its images on
    insert, so nothing holds a frame's buffer for long."""
    gw_ptr = _check_cuda_inputs(image, gamma_grad_weight)
    lay = pyramid_layout(image.shape[0], image.shape[1], n_levels)
    buf = torch.empty(lay.total, dtype=torch.float32, device=image.device)
    _launch(image.contiguous(), buf, n_levels, gw_ptr)
    return pyramid_views(buf, lay)


def build_direct_pyramid_cuda_per_level(image: torch.Tensor, n_levels: int,
                                        gamma_grad_weight: Optional[torch.Tensor] = None):
    """The earlier design, one kernel launch per level after a float32 cast:
    the yardstick the fused kernel is timed against. No path of the system
    calls it."""
    global per_level_launches
    gw_ptr = _check_cuda_inputs(image, gamma_grad_weight)
    pyramid_layout(image.shape[0], image.shape[1], n_levels)
    _, level = _kernels()
    stream = torch.cuda.current_stream(image.device).cuda_stream
    img = image.to(torch.float32).contiguous()
    levels, grads = [], []
    for _ in range(n_levels):
        H, W = img.shape
        out3 = torch.empty((H, W, 3), dtype=torch.float32, device=img.device)
        g2 = torch.empty((H, W), dtype=torch.float32, device=img.device)
        down = torch.empty((H // 2, W // 2), dtype=torch.float32, device=img.device)
        err = level(img.data_ptr(), out3.data_ptr(), g2.data_ptr(),
                    down.data_ptr(), gw_ptr, H, W, stream)
        if err != 0:
            raise RuntimeError(f"pyramid kernel launch failed: cudaError {err}")
        per_level_launches += 1
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
    the (H_l, W_l) squared gradient magnitude, float32. CUDA tensors go
    through the kernel (or raise), uint8 and float32 as they come; CPU
    tensors through the plain version, cast to float32 first."""
    global plain_calls
    if image.device.type == "cuda":
        if image.dtype not in (torch.uint8, torch.float32):
            image = image.to(torch.float32)
        return build_direct_pyramid_cuda(image, n_levels, gamma_grad_weight)
    if image.device.type != "cpu":
        raise ValueError(f"no pyramid route for device {image.device}")
    plain_calls += 1
    return build_direct_pyramid_plain(image.to(torch.float32), n_levels, gamma_grad_weight)
