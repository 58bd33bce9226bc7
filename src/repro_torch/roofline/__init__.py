"""Roofline of one step on an H100: the terms (``analysis``) and the
count of a step's FLOPs, HBM bytes, peak live bytes and, under a device
mesh, one rank's collective bytes on the ``meta`` device (``cost``)."""
from repro_torch.roofline.analysis import (HW_H100, Hardware, model_flops,
                                           roofline_terms)
from repro_torch.roofline.cost import count

__all__ = ["HW_H100", "Hardware", "count", "model_flops", "roofline_terms"]
