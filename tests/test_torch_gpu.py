"""Card-only tests of the port's CUDA kernel: the hand-written pyramid
kernel against its plain torch version on the same CUDA tensors, and the
wrapper's refusals. Every test here needs a CUDA device and skips without
one. The file imports no jax, so on a GPU host without jax it runs without
tests/conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

from hslam_tpu_torch.ops import pyramid as P

torch.set_num_threads(1)

# tolerances of tests/test_pallas.py: levels differ only by f32 summation
# order of the 2x2 mean; g2 is a square of differences (values up to ~1e4)
LEVEL_ATOL = 1e-4
G2_RTOL, G2_ATOL = 1e-5, 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pyramid kernel has no CPU mode")
    return torch.device("cuda")


def _img(h, w, seed):
    return np.random.default_rng(seed).uniform(0.0, 255.0, (h, w)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(480, 640), (481, 643), (1, 1), (3, 5)])
@pytest.mark.parametrize("gamma", [False, True], ids=["plain", "gamma"])
def test_kernel_matches_plain_on_card(cuda_device, shape, gamma):
    img = torch.from_numpy(_img(*shape, seed=11)).to(cuda_device)
    gw = (torch.linspace(0.5, 1.5, 256, device=cuda_device) if gamma else None)
    n = 6 if shape[0] > 100 else 1
    launches, plain = P.kernel_launches, P.plain_calls
    lv, gr = P.build_direct_pyramid(img, n, gw)
    torch.cuda.synchronize()
    assert P.kernel_launches == launches + n and P.plain_calls == plain
    lp, gp = P.build_direct_pyramid_plain(img, n, gw)
    for a, b in zip(lv, lp):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0.0, atol=LEVEL_ATOL)
    for a, b in zip(gr, gp):
        torch.testing.assert_close(a, b, rtol=G2_RTOL, atol=G2_ATOL)


@pytest.mark.gpu
def test_uint8_frame_is_cast_then_launched(cuda_device):
    img = torch.from_numpy(np.round(_img(48, 64, 2)).astype(np.uint8)).to(cuda_device)
    launches = P.kernel_launches
    lv, gr = P.build_direct_pyramid(img, 3)
    torch.cuda.synchronize()
    assert P.kernel_launches == launches + 3
    lp, gp = P.build_direct_pyramid_plain(img.float(), 3)
    for a, b in zip(lv + gr, lp + gp):
        torch.testing.assert_close(a, b, rtol=G2_RTOL, atol=LEVEL_ATOL)


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    img = torch.from_numpy(_img(32, 32, 3)).to(cuda_device)
    with pytest.raises(ValueError):            # gamma weight on another device
        P.build_direct_pyramid(img, 2, torch.ones(256))
    with pytest.raises(ValueError):            # gamma weight of the wrong size
        P.build_direct_pyramid(img, 2, torch.ones(255, device=cuda_device))
    with pytest.raises(ValueError):            # more levels than the image has
        P.build_direct_pyramid(img[:4, :4].contiguous(), 4)
