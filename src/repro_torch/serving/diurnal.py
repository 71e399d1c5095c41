"""Diurnal load traces (paper Fig. 2d / Fig. 8b).

Synchronous day-night pattern with a morning shoulder and an evening peak,
plus Poisson-ish jitter; all services peak at similar times (the paper's
key observation — synchronized peaks force worst-case provisioning).
"""
from __future__ import annotations

import numpy as np


def diurnal_trace(
    peak_qps: float,
    n_steps: int = 144,            # 24h at 10-minute provisioning intervals
    valley_frac: float = 0.45,     # >50% peak-to-valley fluctuation (paper)
    peak_hour: float = 20.0,
    shoulder_hour: float = 11.0,
    jitter: float = 0.02,
    seed: int = 0,
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 24.0, n_steps, endpoint=False)
    main = np.exp(-0.5 * ((t - peak_hour) / 3.5) ** 2)
    shoulder = 0.7 * np.exp(-0.5 * ((t - shoulder_hour) / 3.0) ** 2)
    base = valley_frac + (1.0 - valley_frac) * np.maximum(main, shoulder)
    noise = 1.0 + jitter * rng.standard_normal(n_steps)
    return np.clip(peak_qps * base * noise, 0.0, None)


def load_increment_rate(trace: np.ndarray) -> float:
    """Max step-to-step relative increase — the paper's estimate for the
    over-provision rate R (load growth within one provisioning interval)."""
    prev = np.maximum(trace[:-1], 1e-9)
    return float(np.max((trace[1:] - trace[:-1]) / prev).clip(0.0, 1.0))
