"""Architecture configs of the port.

- ``paper_models``: the six models of paper Table I at production and
  small scale, with their SLAs and operator profiles, and the LM-decode
  serving tenant ``llama3.2-3b-decode``.
- ``dlrm_rm2``, ``wide_deep``, ``din_arch``, ``mind_arch``,
  ``llama3_2_3b``: the assigned architectures ported so far
  (``FULL``, ``SMOKE``, ``SHAPES``); ``registry.get_arch`` finds them.
- ``shapes``: the input-shape cells per family.
"""
