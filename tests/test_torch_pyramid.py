"""hslam_tpu_torch.ops.pyramid: the plain version against the JAX package's
jnp pyramid and its Pallas kernel in interpret mode, and routing by device.
The hand-written kernel against the plain version, on a card, is in
tests/test_torch_gpu.py (which imports no jax, so it runs on a GPU host)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.ops.pallas_kernels import build_direct_pyramid_pallas
from hslam_tpu.ops.pyramid import build_direct_pyramid as jax_pyramid
from hslam_tpu_torch.ops import pyramid as P

torch.set_num_threads(1)

# tolerances of tests/test_pallas.py: levels differ only by f32 summation
# order of the 2x2 mean; g2 is a square of differences (values up to ~1e4)
LEVEL_ATOL = 1e-4
G2_RTOL, G2_ATOL = 1e-5, 1e-2


def _img(h, w, seed):
    return np.random.default_rng(seed).uniform(0.0, 255.0, (h, w)).astype(np.float32)


def _gamma():
    return np.linspace(0.5, 1.5, 256).astype(np.float32)


def _compare(port, ref):
    (lv_t, gr_t), (lv_r, gr_r) = port, ref
    assert len(lv_t) == len(lv_r)
    for a, b in zip(lv_t, lv_r):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LEVEL_ATOL)
    for a, b in zip(gr_t, gr_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=G2_RTOL, atol=G2_ATOL)


@pytest.mark.parametrize("shape", [(64, 96), (65, 97)], ids=["even", "odd"])
@pytest.mark.parametrize("gamma", [False, True], ids=["plain", "gamma"])
@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
def test_plain_pyramid_matches_jax(shape, gamma, reference):
    img = _img(*shape, seed=shape[0] + 7 * gamma)
    gw = _gamma() if gamma else None
    if reference == "jnp":
        ref = jax_pyramid(jnp.asarray(img), 4, None if gw is None else jnp.asarray(gw))
    else:
        ref = build_direct_pyramid_pallas(jnp.asarray(img), 4,
                                          None if gw is None else jnp.asarray(gw),
                                          interpret=True)
    port = P.build_direct_pyramid(torch.from_numpy(img), 4,
                                  None if gw is None else torch.from_numpy(gw))
    _compare(port, ref)


def test_uint8_input_is_cast_first():
    img = np.round(_img(40, 52, 3)).astype(np.uint8)
    lv, gr = P.build_direct_pyramid(torch.from_numpy(img), 3)
    rl, rg = jax_pyramid(jnp.asarray(img, jnp.float32), 3)
    assert lv[0].dtype == torch.float32
    _compare((lv, gr), (rl, rg))


def test_cpu_tensor_routes_to_plain_version():
    launches, plain = P.kernel_launches, P.plain_calls
    P.build_direct_pyramid(torch.from_numpy(_img(32, 48, 1)), 3)
    assert P.kernel_launches == launches
    assert P.plain_calls == plain + 1


def test_cuda_wrapper_rejects_cpu_tensor():
    with pytest.raises(ValueError):
        P.build_direct_pyramid_cuda(torch.from_numpy(_img(8, 8, 0)), 2)

