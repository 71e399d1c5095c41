"""Serving substrate of the port: the k-server FIFO engine, the blocked
event core, the discrete-event simulator and the query router (numpy copies
of ``repro.serving``)."""
