"""Hercules core of the port: workload profiles, device profiles, the
analytic performance model, partition plans, the gradient search, the
profile cache, the efficiency table, the cluster provisioner with its LP,
the baselines and the co-location packer (numpy copies of
``repro.core``)."""
