"""Paper Table I: the six production recommendation models (port copy).

Two scales per model: PROD (production embedding-table sizes; what the
CPU/NMP servers host) and SMALL (the reduced tables the paper uses on
16 GB accelerators — "only the smaller versions ... are used" §III-B).
SLA targets from Fig. 15: RMC1 20ms, RMC2 50ms, RMC3 50ms, DIN 50ms,
DIEN 100ms, MT-WnD 100ms.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import llama3_2_3b
from repro_torch.core.workload import ModelProfile, profile_lm_decode, profile_recsys
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.recsys_base import RecsysConfig

SLA_MS = {
    "dlrm-rmc1": 20.0,
    "dlrm-rmc2": 50.0,
    "dlrm-rmc3": 50.0,
    "din": 50.0,
    "dien": 100.0,
    "mt-wnd": 100.0,
}


def _dlrm(name: str, n_tables: int, rows: int, pooling: int, bottom, top,
          dim: int = 32) -> RecsysConfig:
    return RecsysConfig(
        name=name,
        embedding=EmbeddingConfig(
            vocab_sizes=(rows,) * n_tables, dim=dim, pooling=(pooling,) * n_tables
        ),
        n_dense=13,
        bottom_mlp=bottom,
        top_mlp=top,
        interaction="dot",
    )


def rmc1(prod: bool = True) -> RecsysConfig:
    # ~10 tables, 1M-5M rows, 20-160 lookups, bottom 256-128-32, top 256-64-1
    rows = 2_500_000 if prod else 1_000_000
    return _dlrm("dlrm-rmc1", 10, rows, 80, (256, 128, 32), (256, 64))


def rmc2(prod: bool = True) -> RecsysConfig:
    # ~100 tables (memory-dominated), smaller per-table pooling
    rows = 2_500_000 if prod else 1_000_000
    n = 100 if prod else 40
    return _dlrm("dlrm-rmc2", n, rows, 80, (256, 128, 32), (512, 128))


def rmc3(prod: bool = True) -> RecsysConfig:
    # 10 tables of 10-20M rows, 20-50 lookups, wide bottom FC (compute-heavy)
    rows = 15_000_000 if prod else 1_000_000
    return _dlrm("dlrm-rmc3", 10, rows, 30, (2560, 512, 32), (512, 128))


def mt_wnd(prod: bool = True, n_tasks: int = 5) -> RecsysConfig:
    # 26 one-hot tables, N multi-task towers of 1024-512-256
    rows = 20_000_000 if prod else 1_000_000
    return RecsysConfig(
        name="mt-wnd",
        embedding=EmbeddingConfig(
            vocab_sizes=(rows,) * 26, dim=32, pooling=(1,) * 26
        ),
        n_dense=13,
        top_mlp=(1024, 512, 256),
        interaction="concat",
        n_tasks=n_tasks,
    )


def din(prod: bool = True) -> RecsysConfig:
    # 3 tables (item/user/context), behaviour seq up to 100-1000
    item_rows = 600_000_000 if prod else 1_000_000
    return RecsysConfig(
        name="din",
        embedding=EmbeddingConfig(
            vocab_sizes=(item_rows, 1_000_000, 100_000),
            dim=18,
            pooling=(1, 1, 1),
            qr_features=(0,) if prod else (),
        ),
        seq_len=200,
        attn_mlp=(80, 40),
        top_mlp=(200, 80),
        interaction="target-attn",
    )


def dien(prod: bool = True) -> RecsysConfig:
    return dataclasses.replace(din(prod), name="dien", use_gru=True)


PAPER_MODELS = {
    "dlrm-rmc1": rmc1,
    "dlrm-rmc2": rmc2,
    "dlrm-rmc3": rmc3,
    "mt-wnd": mt_wnd,
    "din": din,
    "dien": dien,
}

# LM-decode serving workloads (ModelProfile builders, not RecsysConfigs):
# token-granular decode streams that share accelerator hosts with the
# recommendation fleet in the co-location scenarios.  Kept out of
# PAPER_MODELS so the paper-scale sweeps iterate exactly Table I.
LM_CONTEXT = 1024
# One "query" is a full 64-1024-token generation (the query-size sample
# counts decode tokens), so the SLA is per-generation; at 1 s only the
# accelerator hosts are feasible — the LM stream is accel-bound by SLA.
LM_SLA_MS = {"llama3.2-3b-decode": 1000.0}


def _lm_decode_profile(name: str) -> ModelProfile:
    cfg = {"llama3.2-3b-decode": llama3_2_3b.FULL}[name]
    # the profile carries the serving-workload name, not the arch id, so
    # efficiency-table rows and profile-cache keys line up with the
    # scenario's workload list
    cfg = dataclasses.replace(cfg, name=name)
    return profile_lm_decode(cfg, LM_CONTEXT, LM_SLA_MS[name])


# Every workload the serving stack can schedule: the six paper models plus
# the LM-decode streams.
SERVING_MODELS = dict(PAPER_MODELS)
SERVING_MODELS["llama3.2-3b-decode"] = _lm_decode_profile


def paper_profile(name: str, prod: bool = True) -> ModelProfile:
    if name in LM_SLA_MS:
        return _lm_decode_profile(name)
    cfg = PAPER_MODELS[name](prod)
    return profile_recsys(cfg, SLA_MS[name])
