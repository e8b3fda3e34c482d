"""Host-side (fp64) root presolve of the condensed MIQP: interval
bound tightening + big-M coefficient tightening (classic MIP presolve,
cf. Savelsbergh 1994, "Preprocessing and probing techniques for MIP").
Counterpart of ``pyhybridcontrol_tpu/ops/presolve.py``, the same numpy
passes.

Why this matters here: big-M product rows (z ≤ Mδ, z ≥ x − M(1−δ), …)
make the QP RELAXATION structurally loose — the pwa_spring root
relaxation is 0.0 against an optimum of ~73–83, so no dual-bound
machinery can prune anything. Shrinking M to
the smallest value that keeps both binary slices of each row unchanged
tightens every relaxation in the tree without changing the MIQP:

- A ≤-row  a₋ⱼ·x + aⱼ·δ ≤ b  is fully described by its two slices
  (δ=0: a₋ⱼx ≤ b;  δ=1: a₋ⱼx ≤ b−aⱼ). Any (aⱼ′, b′) preserving both
  slices over the variable box is MIQP-equivalent and, when |aⱼ′|<|aⱼ|,
  strictly tighter for fractional δ.
- aⱼ < 0 (δ=1 relaxes the row): with U = sup over the box of a₋ⱼ·x,
  the δ=1 slice is redundant iff U ≤ b − aⱼ; then aⱼ′ = −max(0, U − b)
  keeps it exactly redundant. (U ≤ b ⇒ the δ-term can be dropped.)
- aⱼ > 0 (δ=1 tightens): if the δ=0 slice is redundant (U ≤ b), shift
  (aⱼ, b) ← (aⱼ − (b − U), U): δ=0 stays redundant, δ=1 unchanged.

Only CONSTANT-rhs rows are touched (rows with any x0/ω sensitivity have
data-dependent b — their slices cannot be certified at build time).

Bound tightening runs the same interval pass as the device-side
ops/admm.py _implied_box, in exact fp64 and iterated with the
coefficient pass to a fixpoint: tighter boxes → smaller U → smaller M
→ tighter implied boxes. Tightened binary bounds are snapped to {0,1}
(a binary with implied lb > 0 is 1 in every feasible point).

Everything is a pure transform of (G, h0, lb, ub): row count, row
order and column count are unchanged, so z-row ρ boosts, soft slacks
and move-blocking maps compose untouched.
"""

from __future__ import annotations

import numpy as np

INF = np.inf


def _interval_pass(G, h, lb, ub, rows):
    """One fp64 interval-tightening pass over the given ≤-rows.
    Returns updated (lb, ub) — mutated copies are the caller's."""
    m, n = G.shape
    for i in rows:
        gi = G[i]
        nz = np.nonzero(gi)[0]
        if len(nz) == 0:
            continue
        contrib = np.where(gi[nz] > 0, gi[nz] * lb[nz], gi[nz] * ub[nz])
        fin = np.isfinite(contrib)
        s_fin = contrib[fin].sum()
        n_inf = int((~fin).sum())
        for t, j in enumerate(nz):
            if n_inf - (0 if fin[t] else 1) > 0:
                continue                     # another unbounded term
            others = s_fin - (contrib[t] if fin[t] else 0.0)
            avail = h[i] - others
            a = gi[j]
            if a > 0:
                cand = avail / a
                if cand < ub[j]:
                    ub[j] = cand
            else:
                cand = avail / a
                if cand > lb[j]:
                    lb[j] = cand
    return lb, ub


def _coef_pass(G, h, lb, ub, rows, bin_idx):
    """One coefficient-tightening pass over binary columns of the
    given rows. Mutates G, h in place; returns the change count."""
    changed = 0
    bset = set(int(j) for j in bin_idx)
    for i in rows:
        gi = G[i]
        nz = [int(j) for j in np.nonzero(gi)[0]]
        bcols = [j for j in nz if j in bset]
        if not bcols:
            continue
        for j in bcols:
            others = [k for k in nz if k != j and G[i, k] != 0.0]
            U = 0.0
            ok = True
            for k in others:
                t = (G[i, k] * ub[k] if G[i, k] > 0 else G[i, k] * lb[k])
                if not np.isfinite(t):
                    ok = False
                    break
                U += t
            if not ok:
                continue
            a = G[i, j]
            # binary's own sup contribution excluded: slices fix δ.
            if a < 0:
                # δ=1 relaxes; tighten only if its slice stays redundant
                if U <= h[i] - a:                # redundant at δ=1
                    new = -max(0.0, U - h[i])
                    if new > a + 1e-12:
                        G[i, j] = new
                        changed += 1
            else:
                if U <= h[i]:                    # δ=0 slice redundant
                    shift = h[i] - U
                    if shift > 1e-12:
                        G[i, j] = a - shift
                        h[i] = U
                        changed += 1
            nz = [int(k) for k in np.nonzero(G[i])[0]]
    return changed


def tighten_condensed(G, h0, lb, ub, binary_mask, const_rows,
                      passes: int = 3):
    """Iterated bound + coefficient tightening. Inputs are NOT mutated.
    Returns (G, h0, lb, ub) with identical shapes.

    ``const_rows``: boolean mask of rows whose rhs carries no x0/ω
    sensitivity — the only rows whose slices are certifiable at build
    time. Bound tightening also only uses these rows (a bound implied
    by a data-dependent row would be invalid for other data)."""
    G = np.array(G, dtype=np.float64)
    h0 = np.array(h0, dtype=np.float64)
    lb = np.array(lb, dtype=np.float64)
    ub = np.array(ub, dtype=np.float64)
    rows = np.nonzero(const_rows)[0]
    bin_idx = np.nonzero(binary_mask)[0]
    for _ in range(passes):
        lb, ub = _interval_pass(G, h0, lb, ub, rows)
        # binaries snap to integral bounds (implied lb>0 ⇒ always 1)
        if len(bin_idx):
            bl = lb[bin_idx]
            bu = ub[bin_idx]
            lb[bin_idx] = np.where(bl > 1e-9, 1.0, 0.0)
            ub[bin_idx] = np.where(bu < 1.0 - 1e-9, 0.0, 1.0)
        ch = _coef_pass(G, h0, lb, ub, rows, bin_idx)
        if ch == 0:
            break
    return G, h0, lb, ub
