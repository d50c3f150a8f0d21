"""The card's constants (``hw``): memory rate, peak rates by operand
type, memory and shared-memory sizes."""
from repro_torch.roofline.hw import H100_HW, HwSpec

__all__ = ["HwSpec", "H100_HW"]
