"""Architecture configs of the port.

- ``paper_models``: the six models of paper Table I at production and
  small scale, with their SLAs and operator profiles, and the LM-decode
  serving tenant ``llama3.2-3b-decode``.
- ``dlrm_rm2``, ``wide_deep``, ``din_arch``, ``mind_arch``,
  ``graphsage_reddit``, ``llama3_2_3b``, ``qwen2_7b``, ``deepseek_67b``,
  ``qwen2_moe_a2_7b``, ``olmoe_1b_7b``: the ten assigned architectures
  (``FULL``, ``SMOKE``, ``SHAPES``); ``registry.get_arch`` finds them.
- ``shapes``: the input-shape cells per family.
"""
