"""hslam_tpu_torch.ops.pyramid: the plain version against the JAX package's
jnp pyramid and its Pallas kernel in interpret mode, routing by device, the
layout of the kernel's one buffer, and the kernel's tiling emulated in torch.
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



# ------------------------------------------- what surrounds the fused kernel
LAYOUT_CASES = [(480, 640, 6), (481, 643, 6), (1, 1, 1), (3, 5, 1), (65, 67, 4), (7, 130, 3)]


@pytest.mark.parametrize("H,W,n", LAYOUT_CASES)
def test_pyramid_layout(H, W, n):
    """Shapes as the plain version's; every sub-buffer 16-byte aligned, none
    overlapping, the total the end of the last; the views are contiguous."""
    lay = P.pyramid_layout(H, W, n)
    lv, gr = P.build_direct_pyramid_plain(torch.zeros(H, W), n)
    assert [tuple(x.shape) for x in gr] == list(lay.shapes)
    spans = []
    for (h, w), o3, og in zip(lay.shapes, lay.off3, lay.offg):
        assert o3 % 4 == 0 and og % 4 == 0
        spans += [(o3, o3 + 3 * h * w), (og, og + h * w)]
    spans.sort()
    assert spans[0][0] == 0
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start < end + 4
    assert spans[-1][1] <= lay.total < spans[-1][1] + 4 and lay.total % 4 == 0
    buf = torch.arange(lay.total, dtype=torch.float32)
    vl, vg = P.pyramid_views(buf, lay)
    for v, ref, off in zip(vl + vg, lv + gr, lay.off3 + lay.offg):
        assert v.shape == ref.shape and v.is_contiguous()
        assert float(v.reshape(-1)[0]) == off and float(v.reshape(-1)[-1]) == off + v.numel() - 1


@pytest.mark.parametrize("H,W,n", [(480, 640, 9), (4, 4, 4), (7, 130, 4), (0, 5, 1), (8, 8, 0)],
                         ids=["nine_levels", "4x4_level3", "7x130_level3", "empty", "no_level"])
def test_pyramid_layout_refuses(H, W, n):
    with pytest.raises(ValueError):
        P.pyramid_layout(H, W, n)


def _down(t):
    return 0.25 * ((t[0::2, 0::2] + t[0::2, 1::2]) + (t[1::2, 0::2] + t[1::2, 1::2]))


def _outputs(img, halo, x0, y0, tw, th, Hl, Wl, gw):
    """[I, dx, dy] and g2 of the tw x th pixels whose first is (x0, y0) of an
    Hl x Wl level, from `img` in which that pixel lies at (halo, halo); the
    border is tested against the level's size."""
    yi, xi = halo + torch.arange(th), halo + torch.arange(tw)
    c = img[yi][:, xi]
    xs, ys = x0 + torch.arange(tw), y0 + torch.arange(th)
    x_in, y_in = (xs > 0) & (xs < Wl - 1), (ys > 0) & (ys < Hl - 1)
    # a neighbour outside the level is never used: its index is clamped and
    # the difference masked, as the kernel guards the read
    right, left = (xi + 1).clamp(max=img.shape[1] - 1), (xi - 1).clamp(min=0)
    below, above = (yi + 1).clamp(max=img.shape[0] - 1), (yi - 1).clamp(min=0)
    zero = torch.zeros(())
    dx = torch.where(x_in[None, :], 0.5 * (img[yi][:, right] - img[yi][:, left]), zero)
    dy = torch.where(y_in[:, None], 0.5 * (img[below][:, xi] - img[above][:, xi]), zero)
    g2 = dx * dx + dy * dy
    if gw is not None:
        w = gw[torch.clamp(c, 0.0, 255.0).to(torch.int32).long()]
        g2 = g2 * w * w
    return torch.stack([c, dx, dy], dim=-1), g2


def _emulate_kernel(image, n_levels, gw):
    """csrc/pyramid.cu in torch: levels 0..3 tile by tile from nothing but each
    32x32 tile's 48x48 patch (halo 8, zero outside the image), the 2x2 piece
    of level 4 each tile hands over, and levels 4.. from level 4's image."""
    TILE, HALO, IN_TILE = 32, 8, 4
    H, W = image.shape
    lay = P.pyramid_layout(H, W, n_levels)
    nan = float("nan")
    pyr = [torch.full((h, w, 3), nan) for h, w in lay.shapes]
    grads = [torch.full((h, w), nan) for h, w in lay.shapes]
    img4 = torch.full(lay.shapes[IN_TILE], nan) if n_levels > IN_TILE else None
    for by in range(-(-H // TILE)):
        for bx in range(-(-W // TILE)):
            gy = by * TILE - HALO + torch.arange(TILE + 2 * HALO)
            gx = bx * TILE - HALO + torch.arange(TILE + 2 * HALO)
            ok = ((gy >= 0) & (gy < H))[:, None] & ((gx >= 0) & (gx < W))[None, :]
            patch = torch.where(ok, image[gy.clamp(0, H - 1)][:, gx.clamp(0, W - 1)],
                                torch.zeros(()))
            for lvl in range(min(n_levels, IN_TILE)):
                if lvl > 0:
                    patch = _down(patch)
                tile, halo = TILE >> lvl, HALO >> lvl
                Hl, Wl = lay.shapes[lvl]
                x0, y0 = bx * tile, by * tile
                tw, th = min(tile, Wl - x0), min(tile, Hl - y0)
                if tw <= 0 or th <= 0:
                    continue
                o3, g2 = _outputs(patch, halo, x0, y0, tw, th, Hl, Wl, gw)
                pyr[lvl][y0:y0 + th, x0:x0 + tw] = o3
                grads[lvl][y0:y0 + th, x0:x0 + tw] = g2
            if img4 is not None:
                piece = _down(patch[1:5, 1:5])          # level 3's tile without its halo
                H4, W4 = lay.shapes[IN_TILE]
                th, tw = max(0, min(2, H4 - 2 * by)), max(0, min(2, W4 - 2 * bx))
                img4[2 * by:2 * by + th, 2 * bx:2 * bx + tw] = piece[:th, :tw]
    img = img4
    for lvl in range(IN_TILE, n_levels):
        if lvl > IN_TILE:
            img = _down(img[: (img.shape[0] // 2) * 2, : (img.shape[1] // 2) * 2])
        Hl, Wl = lay.shapes[lvl]
        pyr[lvl], grads[lvl] = _outputs(img, 0, 0, 0, Wl, Hl, Hl, Wl, gw)
    return pyr, grads


def _depth(H, W):
    return min(P.MAX_LEVELS, int(np.log2(min(H, W))) + 1)


@pytest.mark.parametrize("shape", [(480, 640), (481, 643), (1, 1), (3, 5), (65, 67), (7, 130)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("gamma", [False, True], ids=["plain", "gamma"])
def test_tile_emulator_matches_plain_bit_for_bit(shape, gamma):
    """The kernel's tiling (patch origin, halo per level, the 2i, 2i+1 of the
    next level, the border against the level's own size, the hand-over of
    level 4) gives the plain version's bits at every level the shape has."""
    img = torch.from_numpy(_img(*shape, seed=5 + shape[1]))
    gw = torch.from_numpy(_gamma()) if gamma else None
    n = _depth(*shape)
    lv, gr = _emulate_kernel(img, n, gw)
    lp, gp = P.build_direct_pyramid_plain(img, n, gw)
    assert len(lv) == n
    for a, b in zip(lv + gr, lp + gp):
        assert a.shape == b.shape and torch.equal(a, b)


def test_cuda_routes_refuse_what_they_do_not_take():
    img = torch.from_numpy(_img(8, 8, 0))
    with pytest.raises(ValueError):
        P.launch_pyramid(img, torch.empty(P.pyramid_layout(8, 8, 2).total), 2)
    with pytest.raises(ValueError):
        P.build_direct_pyramid_cuda_per_level(img, 2)
