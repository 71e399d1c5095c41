"""Architecture configs of the port.

- ``paper_models``: the six models of paper Table I at production and
  small scale, with their SLAs and operator profiles.
- ``dlrm_rm2``: the assigned DLRM architecture (``FULL``, ``SMOKE``,
  ``SHAPES``).
- ``shapes``: the input-shape cells per family.
"""
