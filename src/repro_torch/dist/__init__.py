"""Distributed layer of the port.  So far the single-device branches of
the decode attention (``decode``), the cross entropy (``loss``) and the
MoE dispatch (``moe``); the ``torch.distributed`` paths come later."""
