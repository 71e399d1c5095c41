"""The LM-decode serving tenant of the port (``llama3.2-3b-decode``): its
``ModelProfile`` equals the reference's field by field, and the port's
``gradient_search`` on it picks the reference's schedule bitwise on the
accelerator hosts T7 and T11-v5e (the reference picks ``accel_sd`` at
d = 1024 on both)."""
import dataclasses

import numpy as np
import pytest

from repro.configs import paper_models as j_pm
from repro.core import devices as j_dev
from repro.core import gradient_search as j_gs
from repro.core import workload as j_wl
from repro.core.efficiency import default_query_sizes
from repro_torch.configs import llama3_2_3b as t_llama
from repro_torch.configs import paper_models as t_pm
from repro_torch.core import devices as t_dev
from repro_torch.core import gradient_search as t_gs
from repro_torch.core import workload as t_wl

NAME = "llama3.2-3b-decode"


def test_lm_profile_equals_reference():
    assert sorted(t_pm.SERVING_MODELS) == sorted(j_pm.SERVING_MODELS)
    assert t_pm.LM_CONTEXT == j_pm.LM_CONTEXT
    assert t_pm.LM_SLA_MS == j_pm.LM_SLA_MS
    want = dataclasses.asdict(j_pm.paper_profile(NAME))
    assert dataclasses.asdict(t_pm.paper_profile(NAME)) == want
    assert dataclasses.asdict(t_pm.SERVING_MODELS[NAME](NAME)) == want
    assert want["name"] == NAME


@pytest.mark.parametrize("context", [1, 1024, 32768])
def test_profile_lm_decode_equals_reference(context):
    from repro.configs import llama3_2_3b as j_llama

    got = t_wl.profile_lm_decode(t_llama.FULL, context, 250.0)
    want = j_wl.profile_lm_decode(j_llama.FULL, context, 250.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("server", ["T7", "T11-v5e"])
def test_lm_schedule_equals_reference(server):
    sizes = default_query_sizes()
    jr = j_gs.gradient_search(j_pm.paper_profile(NAME),
                              j_dev.SERVER_TYPES[server], sizes)
    tr = t_gs.gradient_search(t_pm.paper_profile(NAME),
                              t_dev.SERVER_TYPES[server], np.array(sizes))
    assert dataclasses.asdict(tr.placement) == dataclasses.asdict(jr.placement)
    assert dataclasses.asdict(tr.sched) == dataclasses.asdict(jr.sched)
    assert (tr.qps, tr.p95_ms, tr.power_w) == (jr.qps, jr.p95_ms, jr.power_w)
    assert tr.trajectory == jr.trajectory
    assert (tr.placement.plan, tr.sched.batch) == ("accel_sd", 1024)
