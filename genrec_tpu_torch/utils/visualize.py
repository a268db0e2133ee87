"""Semantic-ID cluster visualizer: the port's copy of
``genrec_tpu/utils/visualize.py`` (matplotlib and sklearn imported only
when plotting).

Equivalent of `RQ-VAE/visualize_semantic_id_clusters.py:22-304`: joins
course metadata to the code table; prefix-level count bars, a prefix-tree
rendering for one level-1 subtree, an MDS scatter from the
longest-common-prefix distance, and CSV summaries.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def longest_common_prefix_len(a: Sequence[int], b: Sequence[int]) -> int:
    """`visualize_semantic_id_clusters.py:28-35`."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def prefix_distance_matrix(codes: np.ndarray) -> np.ndarray:
    """Pairwise distance = code_len − LCP (`:38-52`), vectorized."""
    codes = np.asarray(codes)
    n, L = codes.shape
    eq = codes[:, None, :] == codes[None, :, :]          # (n, n, L)
    # LCP = index of first mismatch
    lcp = np.where(eq.all(axis=2), L, eq.argmin(axis=2))
    return (L - lcp).astype(np.float64)


def prefix_counts(codes: np.ndarray, depth: int) -> Dict[tuple, int]:
    out: Dict[tuple, int] = {}
    for row in np.asarray(codes):
        key = tuple(int(x) for x in row[:depth])
        out[key] = out.get(key, 0) + 1
    return out


def write_summary_csvs(codes: np.ndarray, names: Optional[List[str]],
                       out_dir: str) -> None:
    """course↔semantic-id alignment + per-prefix tree summary CSVs
    (`semantic_id_viz/*.csv`)."""
    os.makedirs(out_dir, exist_ok=True)
    codes = np.asarray(codes)
    with open(os.path.join(out_dir, "course_semantic_id_alignment.csv"), "w",
              encoding="utf-8") as f:
        f.write("item_index,name," +
                ",".join(f"code_{i}" for i in range(codes.shape[1])) + "\n")
        for i, row in enumerate(codes):
            name = names[i] if names and i < len(names) else ""
            f.write(f"{i},{name}," + ",".join(str(int(c)) for c in row) + "\n")
    for depth in (1, 2):
        counts = prefix_counts(codes, depth)
        with open(os.path.join(out_dir, f"prefix{depth}_counts.csv"), "w") as f:
            f.write("prefix,count\n")
            for k, v in sorted(counts.items()):
                f.write("-".join(map(str, k)) + f",{v}\n")


def plot_cluster_views(codes: np.ndarray, out_dir: str,
                       subtree_prefix1: Optional[int] = None) -> None:
    """Prefix count bars + one prefix-tree + MDS scatter (`:100-272`)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    codes = np.asarray(codes)

    for depth in (1, 2):
        counts = prefix_counts(codes, depth)
        keys = ["-".join(map(str, k)) for k in sorted(counts)]
        vals = [counts[k] for k in sorted(counts)]
        plt.figure(figsize=(max(6, len(keys) * 0.4), 4))
        plt.bar(keys, vals)
        plt.xticks(rotation=90, fontsize=6)
        plt.title(f"prefix-{depth} cluster sizes")
        plt.tight_layout()
        plt.savefig(os.path.join(out_dir, f"prefix{depth}_counts.png"), dpi=150)
        plt.close()

    # prefix tree of one level-1 subtree
    p1 = subtree_prefix1 if subtree_prefix1 is not None else int(codes[0, 0])
    sub = codes[codes[:, 0] == p1]
    plt.figure(figsize=(8, 6))
    for row in sub:
        xs = np.arange(codes.shape[1])
        ys = [int(v) + np.random.uniform(-0.1, 0.1) for v in row]
        plt.plot(xs, ys, alpha=0.3, linewidth=0.8)
    plt.xlabel("code level")
    plt.ylabel("code value")
    plt.title(f"prefix tree for level-1 code {p1} ({len(sub)} items)")
    plt.savefig(os.path.join(out_dir, f"semantic_id_prefix1_{p1}_tree.png"),
                dpi=150)
    plt.close()

    # MDS scatter from LCP distance (subsample for O(n²) safety)
    n = len(codes)
    idx = np.random.default_rng(0).permutation(n)[:min(n, 500)]
    d = prefix_distance_matrix(codes[idx])
    try:
        from sklearn.manifold import MDS
        xy = MDS(n_components=2, dissimilarity="precomputed",
                 random_state=0, normalized_stress="auto").fit_transform(d)
    except Exception:  # sklearn absent → classical MDS via eigendecomposition
        j = np.eye(len(d)) - 1.0 / len(d)
        b = -0.5 * j @ (d ** 2) @ j
        w, v = np.linalg.eigh(b)
        xy = v[:, -2:] * np.sqrt(np.maximum(w[-2:], 0))
    plt.figure(figsize=(6, 6))
    plt.scatter(xy[:, 0], xy[:, 1], c=codes[idx, 0], cmap="tab10", s=12)
    plt.title("MDS of semantic-ID LCP distances (color = level-1 code)")
    plt.savefig(os.path.join(out_dir, "semantic_id_mds.png"), dpi=150)
    plt.close()
