"""Hierarchical clustering, permutation-based tree cutting and admixture
proportions of the PyTorch port (reference: R/AllUtilities.R:386-640
snpgdsHCluster/snpgdsCutTree + src/SNPRelate.cpp:502-690 gnrDistPerm,
R/PCA.R:347-556 snpgdsAdmixProp).

The linkage is scipy's average linkage (UPGMA), as in the JAX package, so
both give the same merges, ties included. ``cut_tree``'s permutation sums
of a large merge run on the card (``perm_cross``, K15); matplotlib is
imported only inside the two drawing functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from scipy.cluster.hierarchy import average as scipy_average, leaves_list
from scipy.spatial.distance import squareform

from ..ops.kernels import perm_cross
from ..utils.device import resolve_device

# the JAX package's route rule: a merge whose U D product has more than
# this many terms (u.size * m) runs on the device, smaller ones on the host
DEVICE_TERMS = 2 ** 24


@dataclass
class HClusterResult:
    sample_id: np.ndarray
    linkage: np.ndarray  # scipy linkage matrix
    merge: np.ndarray  # R hclust$merge convention (n-1, 2)
    order: np.ndarray  # leaf order (0-based)
    dist: Optional[np.ndarray] = None


def hcluster(dist, sample_id=None, need_mat=True,
             hang=0.25) -> HClusterResult:
    """snpgdsHCluster (R/AllUtilities.R:386): average-linkage (UPGMA)
    clustering of a dissimilarity matrix, or of 1 - ibs of an IBS result
    or the diss of a Diss result (either package's, read by attribute).
    ``hang`` matches the reference signature (dendrogram leaf hang, a
    display-time option; applied by draw_tree)."""
    if hasattr(dist, "ibs") and hasattr(dist, "sample_id"):
        sample_id = dist.sample_id
        dist = 1.0 - np.asarray(dist.ibs)
    elif hasattr(dist, "diss") and hasattr(dist, "sample_id"):
        sample_id = dist.sample_id
        dist = dist.diss
    dist = np.asarray(dist, np.float64)
    n = dist.shape[0]
    if sample_id is None:
        raise ValueError("Please specify 'sample.id'.")
    d = dist.copy()
    np.fill_diagonal(d, 0.0)
    link = scipy_average(squareform(d, checks=False))
    merge = np.empty((n - 1, 2), np.int64)
    for i in range(n - 1):
        for k in range(2):
            c = int(link[i, k])
            merge[i, k] = -(c + 1) if c < n else c - n + 1
    return HClusterResult(np.asarray(sample_id, object), link, merge,
                          np.asarray(leaves_list(link)),
                          dist if need_mat else None)


def _dist_between(dist, idx, n1):
    a = idx[:n1]
    b = idx[n1:]
    return dist[np.ix_(a, b)].mean()


def perm_indicator(rng, n_perm: int, m: int, nsub1: int) -> np.ndarray:
    """(n_perm, m) uint8 indicators of n_perm random splits of m members,
    nsub1 of them in the first group: the JAX package's draws (argsort of
    uniforms from ``rng``), so both packages make the same splits."""
    perms = np.argsort(rng.random((n_perm, m)), axis=1)
    u = np.zeros((n_perm, m), np.uint8)
    np.put_along_axis(u, perms[:, :nsub1], 1, axis=1)
    return u


def _perm_cross_means(u: np.ndarray, dsub: np.ndarray,
                      device: torch.device) -> np.ndarray:
    """sum_{i in A_p, j in B_p} D[i, j] for every permutation split p:
    diag(U D (1-U)^T) = rowsum((U @ D) * (1 - U)). A merge past
    DEVICE_TERMS runs on the device (``perm_cross``, K15; the gnrDistPerm
    hot loop, SNPRelate.cpp:549-668), a smaller one on the host, as the
    JAX package routes them."""
    if u.size * dsub.shape[0] > DEVICE_TERMS:
        return perm_cross(torch.from_numpy(u).to(device),
                          torch.from_numpy(dsub).to(device)).cpu().numpy()
    uf = u.astype(np.float64)
    w = uf @ dsub
    return (w * (1.0 - uf)).sum(1)


@dataclass
class CutTreeResult:
    sample_id: np.ndarray
    z_threshold: float
    outlier_n: int
    samp_order: np.ndarray
    samp_group: np.ndarray  # group label per sample
    dmat: np.ndarray
    merge: Optional[dict] = None
    clust_count: Optional[dict] = None


def cut_tree(hc: HClusterResult, z_threshold=15.0, outlier_n=5, n_perm=5000,
             samp_group=None, col_outlier="red", col_list=None,
             pch_outlier=4, pch_list=None, label_H=False, label_Z=True,
             seed=None, verbose=False, device=None) -> CutTreeResult:
    """snpgdsCutTree (R/AllUtilities.R:432): determine subgroups by
    permutation Z-scores on merge heights (gnrDistPerm,
    SNPRelate.cpp:549-668). ``hc`` is read by attribute (dist, merge,
    order, sample_id), so a JAX package result serves as well; the
    permutations are the JAX package's draws from ``seed``. device: None =
    the CUDA card (for the merges past DEVICE_TERMS); "cpu" runs the plain
    version there."""
    dev = resolve_device(device)
    if hc.dist is None:
        raise ValueError("`hc` should have a matrix of dissimilarity.")
    if n_perm < 50:
        raise ValueError("n_perm >= 50")
    dist = np.asarray(hc.dist, np.float64)
    n = dist.shape[0]
    rng = np.random.default_rng(seed)
    merge_info = None

    if samp_group is None:
        members: list[np.ndarray] = []
        out_z = np.zeros(n - 1)
        out_n1 = np.zeros(n - 1, np.int64)
        out_n2 = np.zeros(n - 1, np.int64)
        for im in range(n - 1):
            i1, i2 = hc.merge[im]
            a1 = np.array([-i1 - 1]) if i1 < 0 else members[i1 - 1]
            a2 = np.array([-i2 - 1]) if i2 < 0 else members[i2 - 1]
            idx = np.concatenate([a1, a2])
            members.append(idx)
            n1, n2 = len(a1), len(a2)
            out_n1[im], out_n2[im] = n1, n2
            if n1 <= 1 and n2 <= 1:
                continue
            L = _dist_between(dist, idx, n1)
            nsub1 = min(n1, n2)
            # the permutation distribution of the between-subset mean
            # distance: mean_p = u_p^T D (1 - u_p) / (n1 n2), u_p the random
            # split's indicator
            m = len(idx)
            u = perm_indicator(rng, n_perm, m, nsub1)
            dsub = dist[np.ix_(idx, idx)]
            d = _perm_cross_means(u, dsub, dev) / (nsub1 * (m - nsub1))
            mean, sd2 = d.mean(), d.var(ddof=1)
            out_z[im] = (L - mean) / np.sqrt(sd2) if sd2 > 0 else 0.0

        # group assignment scan (SNPRelate.cpp:630-668)
        grp_flag = np.zeros(n - 1, bool)
        ind_grp = np.ones(n, np.int64)
        for im in range(n - 1):
            b = out_z[im] >= z_threshold
            if not b:
                i1, i2 = hc.merge[im]
                if i1 > 0 and grp_flag[i1 - 1]:
                    b = True
                if i2 > 0 and grp_flag[i2 - 1]:
                    b = True
            if b:
                grp_flag[im] = True
                idx = members[im]
                n1 = out_n1[im]
                mx = ind_grp[idx[:n1]].max()
                ind_grp[idx[n1:]] += mx
        merge_info = {"z": out_z, "n1": out_n1, "n2": out_n2}

        # label groups; small ones become outliers
        counts = {g: int((ind_grp == g).sum()) for g in np.unique(ind_grp)}
        if np.isfinite(outlier_n):
            outl = {g for g, c in counts.items() if c <= outlier_n}
        else:
            outl = set()
        main = [g for g in sorted(counts) if g not in outl]
        gmap = {g: f"G{k+1:03d}" for k, g in enumerate(main)}
        gmap.update({g: f"Outlier{k+1:03d}"
                     for k, g in enumerate(sorted(outl))})
        samp_group = np.asarray([gmap[g] for g in ind_grp], object)
    else:
        samp_group = np.asarray(samp_group, object)
        if len(samp_group) != n:
            raise ValueError("samp_group length mismatch")

    groups = sorted(set(samp_group.tolist()))
    k = len(groups)
    dmat = np.zeros((k, k))
    for i, gi in enumerate(groups):
        mi = samp_group == gi
        sub = dist[np.ix_(mi, mi)]
        off = ~np.eye(int(mi.sum()), dtype=bool)
        dmat[i, i] = sub[off].mean() if off.any() else 0.0
        for j in range(i + 1, k):
            mj = samp_group == groups[j]
            dmat[i, j] = dmat[j, i] = dist[np.ix_(mi, mj)].mean()

    order = hc.order
    clust_count = {g: int((samp_group == g).sum()) for g in groups}
    res = CutTreeResult(hc.sample_id, z_threshold, outlier_n, order,
                        samp_group, dmat, merge_info, clust_count)
    # display options carried for draw_tree (reference stores them in the
    # returned dendrogram object, R/AllUtilities.R:432+)
    res.display = {"col_outlier": col_outlier, "col_list": col_list,
                   "pch_outlier": pch_outlier, "pch_list": pch_list,
                   "label_H": label_H, "label_Z": label_Z}
    return res


def _merge_node_xy(hc: HClusterResult):
    """(x_center, height) of every merge in dendrogram coordinates
    (scipy leaves sit at 10*rank + 5)."""
    n = len(hc.sample_id)
    rank = np.empty(n, np.int64)
    rank[hc.order] = np.arange(n)
    leaf_x = 10.0 * rank + 5.0
    cx = np.empty(n - 1)
    for i in range(n - 1):
        xs = []
        for k in range(2):
            c = int(hc.linkage[i, k])
            xs.append(leaf_x[c] if c < n else cx[c - n])
        cx[i] = 0.5 * (xs[0] + xs[1])
    return cx, hc.linkage[:, 2].copy()


def draw_tree(cut, hc: HClusterResult = None, type="dendrogram",
              yaxis_height=True, yaxis_kinship=True,
              y_kinship_baseline=np.nan, y_label_kinship=False,
              outlier_n=None,
              shadow_col=((0.5, 0.5, 0.5, 0.25), (0.5, 0.5, 0.5, 0.05)),
              outlier_col=(1.0, 0.5, 0.5, 0.5), leaflab="none",
              labels=None, y_label=0.2, ax=None, **kw):
    """snpgdsDrawTree (R/AllUtilities.R:1761-1896) analog via
    scipy/matplotlib: dendrogram with per-group shadow rectangles (outlier
    groups tinted), optional right-hand coancestry axis with relationship
    guide lines, merge-edge Z/H labels from snpgdsCutTree's label.H/label.Z
    options (R/AllUtilities.R:530-560), or the sorted Z-score profile
    (type="z-score")."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.cluster.hierarchy import dendrogram

    if hasattr(cut, "linkage") and hc is None:
        cut, hc = None, cut

    if type == "z-score":
        if cut is None or cut.merge is None:
            raise ValueError("There is no Z score in this object.")
        y = np.sort(np.asarray(cut.merge["z"]))[::-1]
        if ax is None:
            _fig, ax = plt.subplots(figsize=(6, 4))
        ax.semilogx(np.arange(1, len(y) + 1), y, "+-")
        ax.axhline(15, color="gray", ls="--")
        ax.set_xlabel("the order of Z score")
        ax.set_ylabel("Z score")
        return ax

    if hc is None:
        raise ValueError("draw_tree needs the HClusterResult")
    if ax is None:
        _fig, ax = plt.subplots(figsize=(10, 4))
    ylab = kw.pop("ylab", "individual dissimilarity")
    dendrogram(hc.linkage,
               labels=None if leaflab == "none" else list(hc.sample_id),
               no_labels=leaflab == "none", ax=ax, **kw)
    n = len(hc.sample_id)

    if yaxis_height:
        ax.set_ylabel(ylab)

    baseline = (float(y_kinship_baseline)
                if np.isfinite(y_kinship_baseline)
                else float(hc.linkage[:, 2].max()))
    if yaxis_kinship:
        right = ax.secondary_yaxis("right")
        ym = np.linspace(0, 1, 6)
        right.set_yticks((1 - ym) * baseline, [f"{v:g}" for v in ym])
        right.set_ylabel("coancestry coefficient")
        if y_label_kinship:
            names = ["twins", "PC/FS", "DFC/HS", "FC"]
            for frac, nm in zip((0.5, 0.25, 1 / 8, 1 / 16), names):
                h = (1 - frac) * baseline
                ax.axhline(h, ls="--", color="gray", lw=0.8)
                ax.text(ax.get_xlim()[1], h, nm, fontsize=7,
                        color="gray", va="bottom", ha="right")

    if cut is not None:
        if outlier_n is None:
            outlier_n = cut.outlier_n
        # contiguous group runs along the leaf order -> shadow rectangles
        glab = np.asarray(cut.samp_group, object)[hc.order]
        edges = np.flatnonzero(np.r_[True, glab[1:] != glab[:-1], True])
        jj, k = 0, 0
        y0, y1 = ax.get_ylim()
        for a, b in zip(edges[:-1], edges[1:]):
            cnt = b - a
            if cnt > outlier_n:
                ax.axvspan(10.0 * a, 10.0 * b, color=shadow_col[jj], lw=0)
                jj = 1 - jj
                if labels is not None and k < len(labels):
                    ax.text(10.0 * (a + b) / 2, y_label, labels[k],
                            ha="center")
                k += 1
            else:
                ax.axvspan(10.0 * a, 10.0 * b, color=outlier_col, lw=0)
        # merge-edge Z / H labels (reference attaches these as dendrogram
        # edgetext in snpgdsCutTree, R/AllUtilities.R:530-560)
        disp = getattr(cut, "display", {})
        if cut.merge is not None and (disp.get("label_H")
                                      or disp.get("label_Z", True)):
            cx, hh = _merge_node_xy(hc)
            for i in range(n - 1):
                z = cut.merge["z"][i]
                if z < cut.z_threshold:
                    continue
                if disp.get("label_H"):
                    txt = (f"{hh[i]:.2g} ({z:.1f})"
                           if disp.get("label_Z", True) else f"{hh[i]:.2g}")
                else:
                    txt = f"Z: {z:.1f}"
                ax.annotate(txt, (cx[i], hh[i]), fontsize=6,
                            ha="center", va="bottom",
                            bbox=dict(boxstyle="round,pad=0.1", fc="white",
                                      ec="gray", lw=0.3, alpha=0.8))
        ax.set_ylim(y0, y1)
    return ax


def admix_prop(eigobj, groups: dict, bound=False) -> np.ndarray:
    """snpgdsAdmixProp (R/PCA.R:347): ancestral proportions from the top
    eigenvectors given reference groups {name: [sample ids]}."""
    sample_id = np.asarray(eigobj.sample_id, object)
    E_full = np.asarray(eigobj.eigenvect)
    g = len(groups)
    if g <= 1:
        raise ValueError("groups should have more than one group")
    if g > E_full.shape[1] + 1:
        raise ValueError("`eigobj' should have more eigenvectors than "
                         "what is specified in `groups'.")
    E = E_full[:, : g - 1]
    pos = {s: i for i, s in enumerate(sample_id.tolist())}
    mat = np.zeros((g, g - 1))
    for i, (_name, ids) in enumerate(groups.items()):
        k = [pos[s] for s in ids]
        mat[i] = E[k].mean(0)
    if np.isnan(mat).any():
        raise ValueError("The eigenvectors should not have missing value!")
    t_p = mat[-1]
    t_r = np.linalg.inv(mat[:-1] - t_p[None, :])
    new_p = (E - t_p[None, :]) @ t_r
    new_p = np.concatenate([new_p, 1 - new_p.sum(1, keepdims=True)], axis=1)
    if bound:
        new_p = np.clip(new_p, 0, 1)
        new_p = new_p / new_p.sum(1, keepdims=True)
    return new_p


def admix_plot(propmat: np.ndarray, group=None, col=None, ax=None,
               sort_by_group=True, multiplot=True, showgrp=True,
               shownum=True, ylim=True, na_rm=True):
    """snpgdsAdmixPlot (R/PCA.R:429) analog: stacked-bar ancestry plot.
    multiplot: one panel per ancestral component (the reference default)
    vs a single stacked plot; showgrp/shownum label group spans; ylim=True
    fixes [0,1], a (lo,hi) tuple sets explicit limits; na_rm drops samples
    with missing proportions."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    propmat = np.asarray(propmat, np.float64)
    if na_rm:
        keep = ~np.isnan(propmat).any(1)
        propmat = propmat[keep]
        if group is not None:
            group = np.asarray(group, object)[keep]
    n, k = propmat.shape
    order = np.arange(n)
    if group is not None and sort_by_group:
        order = np.argsort(np.asarray(group, object), kind="stable")

    def _grp_labels(axis):
        if group is None or not showgrp:
            return
        glab = np.asarray(group, object)[order]
        edges = np.flatnonzero(np.r_[True, glab[1:] != glab[:-1], True])
        for a, b in zip(edges[:-1], edges[1:]):
            txt = str(glab[a])
            if shownum:
                txt += f" ({b - a})"
            axis.text((a + b) / 2, 1.02, txt, ha="center", va="bottom",
                      fontsize=8, clip_on=False)
            if b < n:
                axis.axvline(b - 0.5, color="k", lw=0.5)

    if multiplot and ax is None:
        fig, axes = plt.subplots(k, 1, figsize=(10, 1.6 * k), sharex=True)
        axes = np.atleast_1d(axes)
        for j in range(k):
            v = propmat[order, j]
            axes[j].bar(np.arange(n), v, width=1.0,
                        color=None if col is None else col[j % len(col)])
            axes[j].set_xlim(-0.5, n - 0.5)
            if ylim is True:
                axes[j].set_ylim(0, 1)
            elif ylim not in (False, None):
                axes[j].set_ylim(*ylim)
        _grp_labels(axes[0])
        return axes
    if ax is None:
        _fig, ax = plt.subplots(figsize=(10, 3))
    bottom = np.zeros(n)
    for j in range(k):
        v = propmat[order, j]
        ax.bar(np.arange(n), v, bottom=bottom, width=1.0,
               color=None if col is None else col[j % len(col)])
        bottom += v
    ax.set_xlim(-0.5, n - 0.5)
    if ylim is True:
        ax.set_ylim(0, 1)
    elif ylim not in (False, None):
        ax.set_ylim(*ylim)
    _grp_labels(ax)
    return ax


def admix_table(propmat: np.ndarray, group, sort=False):
    """snpgdsAdmixTable (R/PCA.R:525-556): one table per ancestral
    component (propmat column), each a list of per-group rows
    {group, num, mean, sd, min, max}; sort=True orders rows by mean
    descending (the reference's data.frame list, as python dicts)."""
    propmat = np.asarray(propmat, float)
    group = np.asarray(group, object)
    tables = []
    for i in range(propmat.shape[1]):
        rows = []
        for g in sorted(set(group.tolist()), key=str):
            x = group == g
            if not x.any():
                continue
            y = propmat[x, i]
            y = y[~np.isnan(y)]  # na.rm=TRUE in the reference's stats
            rows.append({
                "group": g, "num": int(x.sum()),
                "mean": float(y.mean()) if y.size else float("nan"),
                "sd": float(y.std(ddof=1)) if y.size > 1 else float("nan"),
                "min": float(y.min()) if y.size else float("nan"),
                "max": float(y.max()) if y.size else float("nan")})
        if sort:
            rows.sort(key=lambda r: -r["mean"])
        tables.append(rows)
    return tables
