"""The plain PyTorch versions of the IBD MLE device steps, in float64.

They follow the JAX package's jitted steps of models/ibd_mle.py line for
line: ``_loglik_dev`` (:173), ``_em_loop_dev`` (:182), ``em3`` (:227),
``em9`` (:275), ``nm`` (:565) and ``ll_tile`` (:889). Each takes the staged
Pr(IBS | IBD) table (S, 4, 4, K) float64, the staged genotype codes gT
(N, S) uint8 (0, 1, 2, and 3 for a missing call) and the pair indices i, j
(B,) int64. The kernels of ``csrc/ibd_mle.cu`` (K12 ``ibd_em``, K13
``ibd_simplex``, K14 ``ibd_loglik``) compute the same pair by pair without
gathering; these versions gather the (B, S, K) probabilities of the pairs,
so a caller bounds B.

Every per-SNP mixture is summed over the IBD states in state order, as the
kernels sum it, so kernel and plain version differ only in the order of
the sums over SNPs.
"""

from __future__ import annotations

import torch

# the candidate (k0, k1) of the relatedness adjust, in the order they are
# tried (each better one replaces the result in turn)
RELATEDNESS_K = {"self": (0.0, 0.0), "fullsib": (0.25, 0.5),
                 "offspring": (0.0, 1.0), "halfsib": (0.5, 0.5),
                 "cousin": (0.75, 0.25), "unrelated": (1.0, 0.0)}


def candidates(device) -> torch.Tensor:
    """(6, 3) float64 (k0, k1, k2) of RELATEDNESS_K, in its order."""
    return torch.tensor([(k0, k1, 1 - k0 - k1)
                         for k0, k1 in RELATEDNESS_K.values()],
                        dtype=torch.float64, device=device)


def gather(table: torch.Tensor, gT: torch.Tensor, i: torch.Tensor,
           j: torch.Tensor) -> torch.Tensor:
    """(B, S, K) Pr(IBS | IBD state) of the pairs (i, j): table[s, g_i,
    g_j] at every SNP s."""
    S = table.shape[0]
    c = gT[i].long() * 4 + gT[j].long()
    return table.reshape(S, 16, -1)[torch.arange(S, device=table.device), c]


def _mix(pr: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(B, S) sum_k pr[b, s, k] p[b, k], added in state order."""
    s = pr[..., 0] * p[:, 0, None]
    for k in range(1, pr.shape[-1]):
        s = s + pr[..., k] * p[:, k, None]
    return s


def loglik(pr: torch.Tensor, k: torch.Tensor, bad: int) -> torch.Tensor:
    """``_loglik_dev``: (B,) log-likelihood of the mixtures k (B, K); -inf
    where a SNP whose state ``bad`` is possible has a mixture <= 0."""
    s = _mix(pr, k)
    pos = s > 0
    ll = torch.where(pos, torch.log(torch.where(pos, s, 1.0)), 0.0).sum(1)
    badm = ((s <= 0) & (pr[:, :, bad] > 0)).any(1)
    return torch.where(badm, -torch.inf, ll)


def _convtol(ll0: torch.Tensor, reltol: float) -> torch.Tensor:
    return torch.where(torch.isfinite(ll0),
                       torch.clamp_min(reltol * (ll0.abs() + abs(reltol)),
                                       0.0), reltol)


def _em_loop(pr, params, ll0, convtol, max_iter: int):
    """``_em_loop_dev``: every pair iterates the EM fixed point until
    |ll - old_ll| <= convtol (old_ll starting at 0), at most max_iter + 1
    trips. A converged pair keeps its pre-update parameters and niter =
    its trip; a pair still running after the last trip keeps its last
    update and niter = max_iter. The converged pairs leave the working set
    (the masked loop freezes them; the values are the same)."""
    b = pr.shape[0]
    out_ll = torch.where(torch.isfinite(ll0), ll0, 1e8)
    niter = torch.full((b,), max_iter, dtype=torch.int32, device=pr.device)
    out_p = params.clone()
    widx = torch.arange(b, device=pr.device)
    p, old, tol = params, torch.zeros_like(ll0), convtol
    for it in range(max_iter + 1):
        if not widx.numel():
            break
        mulsum = _mix(pr, p)
        pos = mulsum > 0
        inv = torch.where(pos, 1.0 / torch.where(pos, mulsum, 1.0), 0.0)
        nsnp = pos.sum(1)
        ll = torch.where(pos, torch.log(torch.where(pos, mulsum, 1.0)),
                         0.0).sum(1)
        newp = p * (pr * inv[..., None]).sum(1) / nsnp[:, None]
        conv = (ll - old).abs() <= tol
        out_ll[widx] = ll
        if bool(conv.any()):
            out_p[widx[conv]] = p[conv]
            niter[widx[conv]] = it
            keep = ~conv
            widx, pr, newp, ll, tol = (widx[keep], pr[keep], newp[keep],
                                       ll[keep], tol[keep])
        p, old = newp, ll
    out_p[widx] = p
    return out_p, out_ll, niter


def ibd_em_plain(table: torch.Tensor, gT: torch.Tensor, i: torch.Tensor,
                 j: torch.Tensor, init: torch.Tensor, max_iter: int,
                 reltol: float, adjust: bool = False):
    """Plain version of :func:`kernels.ibd_em`: ``em3`` (K = 3, init =
    (k0, k1, 1 - k0 - k1), the adjust) or ``em9`` (K = 9, the Jacquard
    start). Returns (params (B, K), loglik (B,), niter (B,) int32)."""
    K = table.shape[-1]
    pr = gather(table, gT, i, j)
    ll0 = loglik(pr, init, 0 if K == 3 else K - 1)
    p, ll, niter = _em_loop(pr, init, ll0, _convtol(ll0, reltol), max_iter)
    if adjust:
        for kc in candidates(table.device):
            cll = loglik(pr, kc.expand(len(p), 3), 0)
            better = torch.isfinite(cll) & (ll < cll)
            p = torch.where(better[:, None], kc, p)
            ll = torch.where(better, cll, ll)
    return p, ll, niter


def _nm_obj(a0, a1, a2, x):
    """nm's objective: -loglik at x (B, 2) = (k0, k1), 1e30 outside the
    simplex or where an observed state has probability 0."""
    k0, k1 = x[:, 0], x[:, 1]
    s = a0 * k0[:, None] + a1 * k1[:, None] + a2
    pos = s > 0
    bad = ((~pos) & (a0 > 0)).any(1)
    ll = torch.where(pos, torch.log(torch.where(pos, s, 1.0)), 0.0).sum(1)
    invalid = (k0 < 0) | (k1 < 0) | (k0 + k1 > 1) | bad
    rv = torch.where(invalid, torch.inf, -ll)
    return torch.where(torch.isfinite(rv), rv, 1e30)


def _take(y, i):
    return y.gather(1, i[:, None])[:, 0]


def _take2(p, i):
    return p.gather(1, i[:, None, None].expand(-1, 1, 2))[:, 0]


def _setv(p, i, val, upd):
    """p[:, i] = val where upd (p (B, 3, 2) or y (B, 3))."""
    m = (torch.arange(3, device=p.device)[None, :] == i[:, None]) \
        & upd[:, None]
    if p.dim() == 3:
        return torch.where(m[:, :, None], val[:, None, :], p)
    return torch.where(m, val[:, None], p)


def _order(y):
    """nm's vertex ordering: ilo the last lowest (<=), ihi the first
    highest (>), inhi the next highest."""
    b = y.shape[0]
    ilo = torch.zeros(b, dtype=torch.long, device=y.device)
    ihi = torch.where(y[:, 0] > y[:, 1], 0, 1)
    inhi = 1 - ihi
    for i in range(3):
        yi = y[:, i]
        ilo = torch.where(yi <= _take(y, ilo), i, ilo)
        hi = yi > _take(y, ihi)
        inhi = torch.where(hi, ihi, inhi)
        ihi = torch.where(hi, i, ihi)
        nhi = (~hi) & (yi > _take(y, inhi)) & (ihi != i)
        inhi = torch.where(nhi, i, inhi)
    return ilo, ihi, inhi


def _psum(p):
    return p[:, 0] + p[:, 1] + p[:, 2]


def ibd_simplex_plain(table: torch.Tensor, gT: torch.Tensor,
                      i: torch.Tensor, j: torch.Tensor, k0: torch.Tensor,
                      k1: torch.Tensor, max_iter: int, reltol: float,
                      adjust: bool = False):
    """Plain version of :func:`kernels.ibd_simplex`: ``nm``, the masked
    batched Nelder-Mead on -loglik over (pr0 - pr2, pr1 - pr2, pr2) from
    the simplex of genIBD.cpp:745-757, every pair a step a trip. Returns
    (k0, k1, loglik, nfunk int32), each (B,)."""
    pr = gather(table, gT, i, j)
    a0 = pr[:, :, 0] - pr[:, :, 2]
    a1 = pr[:, :, 1] - pr[:, :, 2]
    a2 = pr[:, :, 2].contiguous()
    del pr
    b = len(k0)
    dev = table.device

    def obj(x):
        return _nm_obj(a0, a1, a2, x)

    p = torch.zeros((b, 3, 2), dtype=torch.float64, device=dev)
    p[:, 0, 0], p[:, 0, 1] = k0, k1
    f = (1 - k0) / 2
    p[:, 1, 0] = k0
    p[:, 1, 1] = torch.where(k1 <= f, k1 + torch.maximum(k1, f - k1) / 2,
                             k1 - torch.maximum(k1 - f, 1 - k0 - k1))
    p[:, 2, 1] = k1
    f = (1 - k1) / 2
    p[:, 2, 0] = torch.where(k0 <= f, k0 + torch.maximum(k0, f - k0) / 2,
                             k0 - torch.maximum(k0 - f, 1 - k1 - k0) / 2)
    y = torch.stack([obj(p[:, v]) for v in range(3)], 1)
    eps = torch.finfo(torch.float64).eps
    convtol = torch.clamp_min(reltol * (y[:, 0].abs() + abs(reltol)), eps)
    psum = _psum(p)
    nfunk = torch.full((b,), 2, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    out_x = torch.zeros((b, 2), dtype=torch.float64, device=dev)
    out_y = torch.zeros(b, dtype=torch.float64, device=dev)
    out_n = torch.zeros(b, dtype=torch.int32, device=dev)
    while bool(active.any()):
        ilo, ihi, inhi = _order(y)
        y_ilo, y_ihi, y_inhi = _take(y, ilo), _take(y, ihi), _take(y, inhi)
        done = active & ((y_ihi - y_ilo <= convtol) | (nfunk >= max_iter))
        out_x = torch.where(done[:, None], _take2(p, ilo), out_x)
        out_y = torch.where(done, y_ilo, out_y)
        out_n = torch.where(done, nfunk, out_n)
        active = active & ~done
        nfunk = nfunk + 2 * active.int()

        def try_point(p, y, psum, fac, gate):
            fac1 = (1.0 - fac) / 2.0
            fac2 = fac1 - fac
            p_hi = _take2(p, ihi)
            ptry = psum * fac1 - p_hi * fac2
            ytry = obj(ptry)
            upd = gate & (ytry < _take(y, ihi))
            psum = torch.where(upd[:, None], psum + ptry - p_hi, psum)
            return (_setv(p, ihi, ptry, upd), _setv(y, ihi, ytry, upd),
                    psum, ytry)

        # reflect; expand; contract, and shrink where the contraction fails
        p, y, psum, ytry = try_point(p, y, psum, -1.0, active)
        m_exp = active & (ytry <= y_ilo)
        m_con = active & ~m_exp & (ytry >= y_inhi)
        p, y, psum, _ = try_point(p, y, psum, 2.0, m_exp)
        ysave = _take(y, ihi)
        p, y, psum, ytry2 = try_point(p, y, psum, 0.5, m_con)
        m_shr = m_con & (ytry2 >= ysave)
        i1 = (ilo == 0).long()
        i2 = torch.where(ilo == 2, 1, 2)
        p_lo = _take2(p, ilo)
        for iv in (i1, i2):
            newp = 0.5 * (_take2(p, iv) + p_lo)
            ynew = obj(newp)
            p = _setv(p, iv, newp, m_shr)
            y = _setv(y, iv, ynew, m_shr)
        nfunk = nfunk + 2 * m_shr.int()
        psum = torch.where(m_shr[:, None], _psum(p), psum)
        nfunk = nfunk - (active & ~m_exp & ~m_con).int()
    out_k0, out_k1, out_ll = out_x[:, 0], out_x[:, 1], -out_y
    if adjust:
        for kc in candidates(dev):
            rv = obj(kc[:2].expand(b, 2))
            cll = torch.where(rv >= 1e30, -torch.inf, -rv)
            better = torch.isfinite(cll) & (out_ll < cll)
            out_k0 = torch.where(better, kc[0], out_k0)
            out_k1 = torch.where(better, kc[1], out_k1)
            out_ll = torch.where(better, cll, out_ll)
    return out_k0, out_k1, out_ll, out_n


def ibd_loglik_plain(table: torch.Tensor, gT: torch.Tensor,
                     i: torch.Tensor, j: torch.Tensor,
                     k: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`kernels.ibd_loglik`: ``ll_tile``, the (B,)
    log-likelihood of the given (k0, k1, k2) rows k (B, 3), -inf where an
    observed state has probability 0."""
    return loglik(gather(table, gT, i, j), k, 0)
