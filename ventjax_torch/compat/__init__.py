"""The reference application's public API (the Vent_Analysis class and the
CI module), on the card."""
from ventjax_torch.compat.vent_analysis import Vent_Analysis, extract_attributes

__all__ = ["Vent_Analysis", "extract_attributes"]
