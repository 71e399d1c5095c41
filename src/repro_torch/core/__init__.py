"""Hercules core of the port: workload profiles, device profiles, the
analytic performance model, partition plans and the gradient search
(numpy copies of ``repro.core``)."""
