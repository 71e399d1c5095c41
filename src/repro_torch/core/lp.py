"""LP solver for the provisioning problem (paper Eq. 1-3).

minimize    sum_{h,m} x[h,m] * Power[h,m]
subject to  sum_h x[h,m] * QPS[h,m] >= load[m] * (1 + R)   (per workload)
            sum_m x[h,m] <= N[h]                            (per server type)
            x >= 0

Solved with scipy's HiGHS when available (the paper uses an interior-point
solver), else a built-in dense simplex on the same standard form. The
integer repair (`round_and_repair`) floors the relaxation and greedily adds
the cheapest-per-QPS feasible servers until every load constraint holds —
re-checked post-hoc, since the paper does not specify its rounding.
"""
from __future__ import annotations

import numpy as np

try:
    from scipy.optimize import linprog as _scipy_linprog
except Exception:  # pragma: no cover - scipy always present in this env
    _scipy_linprog = None


def solve_relaxation(qps: np.ndarray, power: np.ndarray, load: np.ndarray,
                     avail: np.ndarray, overprovision: float = 0.0) -> np.ndarray | None:
    """qps/power: [H, M]; load: [M]; avail: [H] -> x [H, M] or None."""
    H, M = qps.shape
    c = power.reshape(-1)
    # A_ub x <= b_ub : capacity rows (H) and negated load rows (M)
    A = np.zeros((H + M, H * M))
    b = np.zeros(H + M)
    for h in range(H):
        A[h, h * M : (h + 1) * M] = 1.0
        b[h] = avail[h]
    for m in range(M):
        for h in range(H):
            A[H + m, h * M + m] = -qps[h, m]
        b[H + m] = -load[m] * (1.0 + overprovision)
    if _scipy_linprog is not None:
        r = _scipy_linprog(c, A_ub=A, b_ub=b, bounds=(0, None), method="highs")
        if not r.success:
            return None
        return r.x.reshape(H, M)
    return _simplex(c, A, b, H, M)


def _simplex(c, A, b, H, M):  # pragma: no cover - scipy fallback
    """Big-M dense simplex on A x <= b (with possibly negative b)."""
    n = len(c)
    m = len(b)
    # convert to equalities with slacks; rows with b<0 need artificials
    T = np.hstack([A, np.eye(m), b.reshape(-1, 1)])
    art_rows = [i for i in range(m) if b[i] < 0]
    for i in art_rows:
        T[i] = -T[i]
    n_art = len(art_rows)
    if n_art:
        art = np.zeros((m, n_art))
        for j, i in enumerate(art_rows):
            art[i, j] = 1.0
        T = np.hstack([T[:, :-1], art, T[:, -1:]])
    big_m = 1e7
    cost = np.concatenate([c, np.zeros(m), big_m * np.ones(n_art), [0.0]])
    basis = []
    for i in range(m):
        if i in art_rows:
            basis.append(n + m + art_rows.index(i))
        else:
            basis.append(n + i)
    for _ in range(2000):
        z = cost[basis] @ T[:, :-1] - cost[:-1]
        j = int(np.argmax(z))
        if z[j] <= 1e-9:
            break
        col = T[:, j]
        ratios = np.where(col > 1e-12, T[:, -1] / np.maximum(col, 1e-12), np.inf)
        i = int(np.argmin(ratios))
        if not np.isfinite(ratios[i]):
            return None
        T[i] /= T[i, j]
        for k in range(m):
            if k != i:
                T[k] -= T[k, j] * T[i]
        basis[i] = j
    x = np.zeros(n + m + n_art)
    for i, bi in enumerate(basis):
        x[bi] = T[i, -1]
    if n_art and x[n + m :].sum() > 1e-6:
        return None
    return x[:n].reshape(H, M)


def solve_geo_spill(loads: np.ndarray,
                    qps_by_region: list[np.ndarray],
                    power_by_region: list[np.ndarray],
                    avail_by_region: list[np.ndarray],
                    allowed: dict[tuple[int, int], np.ndarray],
                    link_cap: dict[tuple[int, int], float],
                    rtt_ms: dict[tuple[int, int], float],
                    must_spill: np.ndarray | None = None,
                    overprovision: np.ndarray | float = 0.0,
                    spill_penalty: float = 1e-6):
    """Helix-style geo placement relaxation for one interval (MILP relaxed).

    Joint LP over per-region fractional server counts ``x_r`` [H_r, M] and
    directed spill rates ``s[(i, j)]`` [M] (QPS of workload m originating
    in region i served in region j):

    minimize    sum_r x_r . power_r  +  eps * sum (1 + rtt) * s
    subject to  sum_h x_r[h,m] qps_r[h,m] >= (1+R_r) * served_r[m]
                served_r[m] = loads[r,m] - out_r[m] + in_r[m]
                out_r[m] <= loads[r,m];  out_r[m] >= must_spill[r,m]
                sum_m s[(i,j)][m] <= link_cap[(i,j)]   (per directed link)
                sum_m x_r[h,m] <= avail_r[h]
                s[(i,j)][m] = 0 where not allowed[(i,j)][m]

    ``loads``/``must_spill``: [R, M]; ``allowed`` masks spill by the caller's
    link/RTT/SLA budgets (Helix's "which models are servable from where").
    The tiny RTT-weighted penalty breaks power ties toward local serving
    and the shortest feasible link without distorting the power objective.
    Returns ``(spill, x)`` — ``spill`` keyed like ``allowed``, ``x`` a list
    of [H_r, M] — or ``None`` when scipy is unavailable or the program is
    infeasible (the caller falls back to greedy water-filling).
    """
    if _scipy_linprog is None:  # pragma: no cover - scipy present in CI
        return None
    R, M = loads.shape
    over = np.broadcast_to(np.asarray(overprovision, dtype=float), (R,))
    if must_spill is None:
        must_spill = np.zeros((R, M))
    pairs = sorted(allowed)
    x_off, n_x = [], 0
    for r in range(R):
        x_off.append(n_x)
        n_x += qps_by_region[r].shape[0] * M
    s_off = {p: n_x + k * M for k, p in enumerate(pairs)}
    n_var = n_x + len(pairs) * M

    c = np.zeros(n_var)
    for r in range(R):
        c[x_off[r]:x_off[r] + power_by_region[r].size] = \
            power_by_region[r].reshape(-1)
    for p in pairs:
        c[s_off[p]:s_off[p] + M] = spill_penalty * (1.0 + rtt_ms[p])

    rows, b = [], []

    def add_row(coeffs: dict[int, float], rhs: float) -> None:
        row = np.zeros(n_var)
        for j, v in coeffs.items():
            row[j] += v
        rows.append(row)
        b.append(rhs)

    for r in range(R):
        H_r = qps_by_region[r].shape[0]
        for m in range(M):
            co: dict[int, float] = {}
            for h in range(H_r):
                co[x_off[r] + h * M + m] = -float(qps_by_region[r][h, m])
            for p in pairs:
                if p[0] == r:
                    co[s_off[p] + m] = co.get(s_off[p] + m, 0.0) \
                        - (1.0 + over[r])
                if p[1] == r:
                    co[s_off[p] + m] = co.get(s_off[p] + m, 0.0) \
                        + (1.0 + over[r])
            add_row(co, -float(loads[r, m]) * (1.0 + over[r]))
            out_idx = {s_off[p] + m: 1.0 for p in pairs if p[0] == r}
            if out_idx:
                add_row(out_idx, float(loads[r, m]))
                if must_spill[r, m] > 0:
                    add_row({j: -1.0 for j in out_idx},
                            -float(must_spill[r, m]))
            elif must_spill[r, m] > 0:
                return None  # evacuation ordered but no outgoing link
        for h in range(H_r):
            add_row({x_off[r] + h * M + m: 1.0 for m in range(M)},
                    float(avail_by_region[r][h]))
    for p in pairs:
        add_row({s_off[p] + m: 1.0 for m in range(M)},
                float(link_cap[p]))

    bounds = [(0, None)] * n_var
    for p in pairs:
        mask = np.asarray(allowed[p], dtype=bool)
        for m in range(M):
            if not mask[m]:
                bounds[s_off[p] + m] = (0, 0)
    r_ = _scipy_linprog(c, A_ub=np.array(rows), b_ub=np.array(b),
                        bounds=bounds, method="highs")
    if not r_.success:
        return None
    spill = {p: np.maximum(r_.x[s_off[p]:s_off[p] + M], 0.0) for p in pairs}
    x = [r_.x[x_off[r]:x_off[r] + qps_by_region[r].size]
         .reshape(qps_by_region[r].shape) for r in range(R)]
    return spill, x


def round_and_repair(x: np.ndarray, qps: np.ndarray, power: np.ndarray,
                     load: np.ndarray, avail: np.ndarray,
                     overprovision: float = 0.0) -> np.ndarray | None:
    """Integerize the relaxation: floor, then greedily add the cheapest
    power-per-QPS feasible server until all loads are covered."""
    H, M = qps.shape
    n = np.floor(x + 1e-9).astype(np.int64)
    target = load * (1.0 + overprovision)
    for _ in range(int(avail.sum()) + H * M):
        served = (n * qps).sum(axis=0)
        deficit = target - served
        m = int(np.argmax(deficit))
        if deficit[m] <= 1e-9:
            return n
        # cheapest marginal power per unit of *useful* QPS for workload m
        cand, best_cost = None, np.inf
        used = n.sum(axis=1)
        for h in range(H):
            if used[h] >= avail[h] or qps[h, m] <= 0:
                continue
            cost = power[h, m] / min(qps[h, m], deficit[m])
            if cost < best_cost:
                best_cost, cand = cost, h
        if cand is None:
            return None  # infeasible: not enough capacity
        n[cand, m] += 1
    return None
