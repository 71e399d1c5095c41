"""The port's own host spans, for a profiler's timeline.

``span(name)`` opens the host span ``repro_torch.<name>`` while a
``torch.profiler`` records, and is a shared no-op otherwise: spans are on
exactly when someone profiles (a traced benchmark run, an operator
profiling a server), with no switch of their own.  The spans land in the
profiler's host timeline, the clock its device records are mapped to, so
a device operation can be put down to the span in which the host
launched it.

The spans: ``model`` (a model's forward), ``sparse`` (its SparseNet),
``k1`` (K1's forward entries), ``dense`` (its DenseNet) and ``mlp``
(each ``models.layers.apply_mlp`` call).  A disabled call costs the
profiler check and an empty ``with``, a twentieth of what a bare
``record_function`` costs with no profiler running.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A host span ``PREFIX + name`` while a torch profiler records; else a
    shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
