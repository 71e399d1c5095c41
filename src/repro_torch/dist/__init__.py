"""Distributed layer of the port.  So far only the single-device branch
of the decode attention; the ``torch.distributed`` paths come later."""
