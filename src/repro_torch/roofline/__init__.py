"""The card's constants (``hw``): memory rate, peak rates by operand
type, memory and shared-memory sizes; and one step's roofline terms
(``analysis``: the analytic memory and FLOP model, ``count_flops``,
``roofline_terms``)."""
from repro_torch.roofline.hw import H100_HW, HwSpec

__all__ = ["HwSpec", "H100_HW"]
