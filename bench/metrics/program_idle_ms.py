"""program_idle_ms: milliseconds a step in which the card ran nothing
while the host was inside one of the port's spans (all of which lie in
``repro_torch.model`` on the benchmark's path): the program's own
dispatch, as against the harness's waits and copies."""
from bench.progtrace import OUTSIDE


def read(run):
    s = getattr(run, "program", None)
    if s is None:
        return None
    idle = sum(t for n, t in s.idle_by_span_s.items() if n != OUTSIDE)
    return 1e3 * idle / s.steps
