"""Desktop GUI of the port: the counterpart of ``ventjax/gui``.

A copy of ventjax's controller and view over the port's own modules:

  * :mod:`ventjax_torch.gui.controller` — every GUI event as a plain method
    over an explicit :class:`GuiState`; no toolkit import anywhere.  It
    drives the port's ``Vent_Analysis`` on ``device`` (the card unless the
    caller asks for the CPU).
  * :mod:`ventjax_torch.gui.app` — a thin tkinter view binding widgets to
    the controller; tkinter and Pillow are imported inside its functions.

Launch with ``python -m ventjax_torch gui``.
"""
from ventjax_torch.gui.controller import GuiState, Status, VentController

__all__ = ["GuiState", "Status", "VentController"]
