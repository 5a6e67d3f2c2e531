"""Bag-of-binary-words place recognition (port of hslam_tpu/ops/bow.py).

  * the vocabulary is a k^L tree of binary centroids stored as dense arrays
    (level-major); training is batched k-medians on descriptor bits
    (majority vote), done once on the host in numpy: with the same
    descriptors and seed it gives the JAX package's tree bit for bit;
  * quantization descends the tree for all descriptors in parallel: per
    level one (N, k) Hamming distance and an argmin (the first minimum, as
    jnp.argmin: ties are common with k children and 256-bit distances);
  * BoW vectors are dense tf (or tf-idf) vectors over the leaf words;
    similarity is the DBoW3 L1 score s(v, w) = 1 - 0.5 |v/|v| - w/|w||_1.

Descriptors and centroids are (.., 8) int32 words holding the JAX package's
uint32 bits (ops/orb.py), and distances use the same SWAR popcount.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .orb import _popcount64


class Vocabulary(NamedTuple):
    centroids: torch.Tensor   # (L, max_nodes, 8) int32 binary centroids
    k: int                    # branching factor
    levels: int               # tree depth
    n_words: int              # k ** levels
    idf: torch.Tensor         # (n_words,) inverse document frequency


def _vocabulary(cents: np.ndarray, k: int, levels: int, idf: np.ndarray,
                device) -> Vocabulary:
    """A Vocabulary on `device` from uint32 (or int32) centroids."""
    cents = np.ascontiguousarray(cents)
    if cents.dtype == np.uint32:
        cents = cents.view(np.int32)
    return Vocabulary(
        centroids=torch.from_numpy(cents.copy()).to(device), k=int(k),
        levels=int(levels), n_words=int(k) ** int(levels),
        idf=torch.from_numpy(np.asarray(idf, np.float32).copy()).to(device))


def _majority_centroid(descs: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Bitwise majority vote over masked descriptors: (N, 8) uint32 -> (8,)."""
    if mask.sum() == 0:
        return descs[0]
    bits = np.unpackbits(descs[mask].view(np.uint8), axis=1, bitorder="little")
    maj = (bits.mean(axis=0) >= 0.5).astype(np.uint8)
    return np.packbits(maj, bitorder="little").view(np.uint32)


def train_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 3,
                     iters: int = 8, seed: int = 0,
                     doc_ids: np.ndarray | None = None,
                     device="cuda") -> Vocabulary:
    """Host-side k-medians tree training (one-off; numpy).

    descriptors: (N, 8) uint32 (or the port's int32 words). Returns a
    Vocabulary with k^levels words on `device`. `doc_ids` (N,) optionally
    assigns each training descriptor to a document (keyframe); then
    idf = log(n_docs / n_docs_with_word) per word, the DBoW3 way; without
    it idf stays uniform (tf-only scoring).
    """
    descriptors = np.ascontiguousarray(descriptors)
    if descriptors.dtype == np.int32:
        descriptors = descriptors.view(np.uint32)
    rng = np.random.RandomState(seed)
    N = len(descriptors)
    max_nodes = k ** levels
    cents = np.zeros((levels, max_nodes, 8), np.uint32)

    pop_lut = np.array([bin(i).count("1") for i in range(256)], np.uint16)

    def hdist(a, b):
        """(N, 8) x (M, 8) -> (N, M) Hamming distances (byte-LUT popcount)."""
        x = a[:, None, :] ^ b[None, :, :]
        return pop_lut[x.view(np.uint8)].sum(-1, dtype=np.int32)

    def kmedians(data, kk):
        if len(data) == 0:
            return np.zeros((kk, 8), np.uint32), np.zeros(0, np.int64)
        # farthest-point initialization: real descriptor sets are heavily
        # correlated; random init + majority vote collapses every centroid
        # onto the global median and the whole tree degenerates
        c = np.zeros((kk, 8), np.uint32)
        c[0] = data[rng.randint(len(data))]
        dmin = hdist(data, c[:1])[:, 0]
        for j in range(1, kk):
            c[j] = data[int(dmin.argmax())]
            dmin = np.minimum(dmin, hdist(data, c[j: j + 1])[:, 0])
        assign = np.zeros(len(data), np.int64)
        for _ in range(iters):
            d = hdist(data, c)
            assign = d.argmin(-1)
            for j in range(kk):
                mask = assign == j
                if mask.sum() == 0:
                    # reseed an empty cluster with the farthest point
                    far = int(d[np.arange(len(data)), assign].argmax())
                    c[j] = data[far]
                    assign[far] = j
                else:
                    c[j] = _majority_centroid(data, mask)
        return c, assign

    # recursive split, materialized level-major
    groups = {(): np.arange(N)}
    for lvl in range(levels):
        new_groups = {}
        for path, idx in groups.items():
            node_base = 0
            for p_ in path:
                node_base = node_base * k + p_
            c, assign = kmedians(descriptors[idx], k)
            for j in range(k):
                cents[lvl, node_base * k + j, :] = c[j]
                new_groups[path + (j,)] = idx[assign == j]
        groups = new_groups

    n_words = k ** levels
    idf = np.ones(n_words, np.float32)
    if doc_ids is not None and N > 0:
        voc_tmp = _vocabulary(cents, k, levels, idf, "cpu")
        words = quantize(voc_tmp, torch.from_numpy(descriptors.view(np.int32).copy()),
                         torch.ones(N, dtype=torch.bool)).numpy()
        docs = np.asarray(doc_ids)
        n_docs = len(np.unique(docs))
        # docs containing each word (presence, not frequency: DBoW3's Ni)
        seen = np.unique(np.stack([words, docs], 1), axis=0)
        ni = np.bincount(seen[:, 0], minlength=n_words)
        idf = np.where(ni > 0, np.log(n_docs / np.maximum(ni, 1)), 0.0).astype(np.float32)
    return _vocabulary(cents, k, levels, idf, device)


def save_vocabulary(path: str, voc: Vocabulary) -> None:
    """Persist a vocabulary in the JAX package's .npz layout (uint32
    centroids), so either package loads what the other saved."""
    np.savez_compressed(
        path, centroids=voc.centroids.cpu().numpy().view(np.uint32), k=voc.k,
        levels=voc.levels, idf=voc.idf.cpu().numpy())


def load_vocabulary(path: str, device="cuda") -> Vocabulary:
    data = np.load(path)
    return _vocabulary(data["centroids"], int(data["k"]), int(data["levels"]),
                       data["idf"], device)


def quantize(voc: Vocabulary, descs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Descend the tree for all descriptors in parallel.

    descs: (N, 8) int32 -> word ids (N,) int32 (invalid -> -1)."""
    N = descs.shape[0]
    k = voc.k
    d64 = descs.contiguous().view(torch.int64)                      # (N, 4)
    ar = torch.arange(k, device=descs.device)
    node = torch.zeros(N, dtype=torch.int64, device=descs.device)   # index within its level
    for lvl in range(voc.levels):
        # children of `node` at this level occupy [node*k, node*k+k)
        child_base = node * k
        cands = voc.centroids[lvl][child_base[:, None] + ar[None, :]]   # (N, k, 8)
        x = d64[:, None, :] ^ cands.view(torch.int64)
        d = _popcount64(x).sum(-1)
        node = child_base + d.argmin(dim=-1)
    return torch.where(valid, node, -1).to(torch.int32)


def bow_vector(word_ids: torch.Tensor, n_words: int,
               idf: torch.Tensor | None = None) -> torch.Tensor:
    """tf (or tf-idf when `idf` is given) vector (n_words,), L1-normalized
    (DBoW3 TF_IDF weighting + L1_NORM). The counts are an integer
    scatter-add: exact, and independent of the order of the atomics."""
    w = word_ids.long()
    # invalid descriptors count into a scratch bin that is dropped
    slot = torch.where(w >= 0, w, n_words)
    counts = torch.zeros(n_words + 1, dtype=torch.int64, device=w.device)
    counts = counts.index_add(0, slot, torch.ones_like(slot))
    v = counts[:n_words].float()
    if idf is not None:
        v = v * idf
    return v / torch.clamp(v.sum(), min=1e-9)


def l1_score(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """DBoW3 L1 scoring: s = 1 - 0.5 |v - w|_1 for L1-normalized v, w.
    v: (n_words,), db: (M, n_words) -> (M,)."""
    return 1.0 - 0.5 * (v[None, :] - db).abs().sum(-1)
