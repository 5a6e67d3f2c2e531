"""Train a BoW vocabulary offline (counterpart of scripts/train_vocab.py):
a k^L binary-centroid tree with DBoW3-style tf-idf weights, saved as the
.npz that `SLAMSystem(vocab_path=...)` and `run_sequence --vocab` load (the
reference's mandatory vocabulary argument, Main.h:81).

Usage:
    python -m hslam_tpu_torch.tools.train_vocab --dataset /path/to/seq --out vocab.npz \\
        [--k 10 --levels 3 --stride 5 --max-images 500]
    python -m hslam_tpu_torch.tools.train_vocab --synthetic 200 --out vocab.npz
    python -m hslam_tpu_torch.tools.train_vocab --diverse 48 --views 6 --k 10 --levels 4 \\
        --out vocab_10k.npz

`--diverse` trains on generated scenes of four texture families (sinusoid
mixtures, multi-octave smoothed noise, Gaussian blob fields, rotated
checkers and stripes), each seen in several warped and relit views, so the
vocabulary is not specialised to one scene. The families' draws come from
np.random.RandomState(seed) in the JAX script's order, so both scripts
draw the same scenes; the smoothed noise is upsampled by
`F.interpolate(bilinear, align_corners=False)` (the JAX script's
jax.image.resize, half-pixel centres) and the views are warped by
utils/interp.bilinear, on `device`. ORB descriptors are extracted on
`device` (ops/features.extract_multiscale); the tree is trained on the host
(ops/bow.train_vocabulary, numpy). `--synthetic` renders
tools/run_sequence.synthetic_sequence (io/synthetic's plane).
"""
from __future__ import annotations

import argparse
from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import bow as bow_ops
from ..ops import features as ft
from ..utils.interp import bilinear


def diverse_scene_images(n_scenes: int, views: int, seed: int = 0, H: int = 480,
                         W: int = 640, device="cuda") -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (scene index, uint8 view) over n_scenes x views images."""
    dev = torch.device(device)
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)

    def scene_texture(s):
        kind = s % 4
        if kind == 0:          # sinusoid mixture (random spectrum)
            img = np.full((H, W), 120.0, np.float32)
            for _ in range(rng.randint(5, 10)):
                img += rng.uniform(6, 35) * np.sin(
                    2 * np.pi * (rng.uniform(0.5, 14) * xs / W + rng.uniform(0.5, 14) * ys / H)
                    + rng.uniform(0, 6.28))
            return img
        if kind == 1:          # multi-octave smoothed noise
            img = np.zeros((H, W), np.float32)
            for cell, amp in [(8, 60), (16, 45), (32, 35), (64, 25)]:
                small = rng.rand(H // cell + 1, W // cell + 1).astype(np.float32)
                up = F.interpolate(torch.from_numpy(small).to(dev)[None, None], size=(H, W),
                                   mode="bilinear", align_corners=False)[0, 0]
                img += amp * (up.cpu().numpy() - 0.5)
            return 128.0 + img
        if kind == 2:          # gaussian blob field
            img = np.full((H, W), 110.0, np.float32)
            for _ in range(rng.randint(25, 60)):
                cx_, cy_ = rng.uniform(0, W), rng.uniform(0, H)
                sg = rng.uniform(4, 40)
                img += rng.uniform(-70, 70) * np.exp(
                    -((xs - cx_) ** 2 + (ys - cy_) ** 2) / (2 * sg * sg))
            return img
        # kind == 3: rotated checkers / stripes with intensity steps
        th = rng.uniform(0, np.pi)
        xr = np.cos(th) * xs + np.sin(th) * ys
        yr = -np.sin(th) * xs + np.cos(th) * ys
        p1, p2 = rng.uniform(12, 60), rng.uniform(12, 60)
        img = 110.0 + 45.0 * (((xr // p1).astype(int) + (yr // p2).astype(int)) % 2)
        img += 20.0 * np.sin(2 * np.pi * rng.uniform(1, 6) * xs / W + rng.uniform(0, 6.28))
        return img.astype(np.float32)

    for s in range(n_scenes):
        tex = np.clip(scene_texture(s), 0, 255).astype(np.float32)
        tex_dev = torch.from_numpy(tex).to(dev)
        for v in range(views):
            if v == 0:
                img = tex
            else:
                # random similarity warp + brightness/gamma jitter: the views
                # a revisit would produce
                ang = rng.uniform(-0.35, 0.35)
                sc = rng.uniform(0.8, 1.25)
                tx_, ty_ = rng.uniform(-40, 40, 2)
                ca, sa = np.cos(ang) / sc, np.sin(ang) / sc
                cx_, cy_ = W / 2, H / 2
                u = ca * (xs - cx_) - sa * (ys - cy_) + cx_ + tx_
                vv = sa * (xs - cx_) + ca * (ys - cy_) + cy_ + ty_
                img = bilinear(tex_dev, torch.from_numpy(np.asarray(u, np.float32)).to(dev),
                               torch.from_numpy(np.asarray(vv, np.float32)).to(dev)).cpu().numpy()
                gain = rng.uniform(0.8, 1.2)
                gamma = rng.uniform(0.8, 1.25)
                img = 255.0 * (np.clip(img * gain / 255.0, 0, 1) ** gamma)
            yield s, np.clip(np.round(img), 0, 255).astype(np.uint8)


def extract_descs(img: np.ndarray, n_levels: int, capacity: int, fast_th: float,
                  device="cuda") -> np.ndarray:
    """The valid ORB descriptors of one image: (n, 8) uint32."""
    u, v, lvl, sc, desc, valid = ft.extract_multiscale(
        torch.as_tensor(np.asarray(img, np.float32), device=device), n_levels, capacity,
        fast_th)
    return desc[valid].cpu().numpy().view(np.uint32)


def train(descs, doc_ids, k: int, levels: int, iters: int, out: str) -> bow_ops.Vocabulary:
    """The tree over the pooled descriptors (one document per entry of
    `doc_ids`' values), saved to `out`."""
    pool, docs = np.concatenate(descs), np.concatenate(doc_ids)
    print(f"training k={k} L={levels} ({k ** levels} words) on {len(pool)} descriptors "
          f"from {len(descs)} images...")
    voc = bow_ops.train_vocabulary(pool, k=k, levels=levels, iters=iters, doc_ids=docs,
                                   device="cpu")
    bow_ops.save_vocabulary(out, voc)
    idf = voc.idf.numpy()
    print(f"saved {out}: {voc.n_words} words, {int((idf > 0).sum())} observed in training "
          f"(idf range [{idf.min():.2f}, {idf.max():.2f}])")
    return voc


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", type=str, default=None)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="train from N frames of the synthetic sequence")
    ap.add_argument("--diverse", type=int, default=0,
                    help="train from N generated scenes (4 texture families)")
    ap.add_argument("--views", type=int, default=6, help="warped/relit views per diverse scene")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--stride", type=int, default=5, help="use every stride-th image")
    ap.add_argument("--max-images", type=int, default=500)
    ap.add_argument("--features", type=int, default=512)
    ap.add_argument("--fast-th", type=float, default=10.0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if not (args.dataset or args.synthetic or args.diverse):
        ap.error("need --dataset DIR, --synthetic N or --diverse N")
    return args


def run(args) -> bow_ops.Vocabulary:
    descs, doc_ids = [], []

    def add(img, doc):
        d = extract_descs(img, 4, args.features, args.fast_th, args.device)
        descs.append(d)
        doc_ids.append(np.full(len(d), doc, np.int32))
        if len(descs) % 20 == 0:
            print(f"  {len(descs)} images...")

    if args.diverse:
        # document = scene (not view): idf counts a word once per scene
        for s, img in diverse_scene_images(args.diverse, args.views, args.seed,
                                           device=args.device):
            add(img, s)
    elif args.synthetic:
        from .run_sequence import synthetic_sequence
        frames, _, _ = synthetic_sequence(args.synthetic)
        for i, img in enumerate(frames[::args.stride][:args.max_images]):
            add(img, i)
    else:
        from ..io.dataset import DatasetReader
        rd = DatasetReader(args.dataset)
        try:
            for i, fid in enumerate(list(range(0, len(rd), args.stride))[:args.max_images]):
                add(rd.get_raw(fid).image, i)
        finally:
            rd.close()
    return train(descs, doc_ids, args.k, args.levels, args.iters, args.out)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
