"""tkinter view for the port's GUI — renders GuiState, forwards events.

The counterpart of ``ventjax/gui/app.py``.  A thin binding of the
reference's window layout (the reference's Vent_Analysis.py:644-718: path inputs, action buttons,
IRB study columns, dose/PFT fields, patient + DICOM data labels, six image
panes, notes, status line, export row) onto plain tkinter widgets.  All
logic lives in :class:`ventjax_torch.gui.controller.VentController`; this module
only reads controller state after each event and repaints.

Importable without a display; :func:`launch` raises
:class:`GuiUnavailableError` when no X display is reachable, so the CLI
can print an actionable message instead of a TclError traceback.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ventjax_torch.gui.controller import GuiState, VentController

IMAGE_PANES = ("proton", "raw", "n4", "defect", "ci", "twix")
PANE_LABELS = {
    "proton": "Proton", "raw": "Raw + mask", "n4": "N4 + mask",
    "defect": "N4 + defect", "ci": "N4 + CI", "twix": "TWIX recon",
}
DATA_KEYS = (
    "subject", "studydate", "studytime", "age", "sex", "dob", "vox", "snr",
    "vdp", "ventarrayshape", "masklungvol", "defectvolume", "ci",
    "twixdate", "twixprotocol",
)


class GuiUnavailableError(RuntimeError):
    pass


def _pane_photo(arr: np.ndarray, box: int):
    """RGB float array -> PhotoImage scaled to `box` px tall, like the
    reference's arrayToImage (Vent_Analysis.py:616-620)."""
    from PIL import Image, ImageTk

    a = np.asarray(arr, dtype=np.float64)
    img = Image.fromarray(np.clip(a, 0, 255).astype(np.uint8))
    w = max(1, int(box * img.width / max(1, img.height)))
    return ImageTk.PhotoImage(image=img.resize((w, box)))


class VentApp:
    """The window.  Build with a live Tk root; every button handler calls
    the controller then :meth:`refresh`."""

    def __init__(self, root, controller: Optional[VentController] = None,
                 tk_module=None, photo_factory=None, ask_string=None):
        """tk_module/photo_factory/ask_string are dependency seams: the
        default is the real tkinter + PIL PhotoImage + simpledialog, while
        tests drive the SAME widget construction and event wiring through a
        fake toolkit with no display (tests/test_torch_gui.py)."""
        if tk_module is None:
            import tkinter as tk_module

        import ventjax_torch

        tk = tk_module
        self.tk = tk
        self.root = root
        self._photo = photo_factory or _pane_photo
        self._ask_string = ask_string
        self.c = controller or VentController()
        root.title(f"ventjax_torch Ventilation Analysis -- "
                   f"{ventjax_torch.__version__}")

        self._path_vars = {}
        self._photos = {}  # keep PhotoImage refs alive
        top = tk.Frame(root)
        top.pack(fill="x")
        tk.Label(top, text=f"ventjax_torch {ventjax_torch.__version__}   "
                 "User:").pack(side="left")
        self.user_var = tk.StringVar(value=self.c.state.user)
        tk.Entry(top, textvariable=self.user_var, width=8).pack(side="left")
        tk.Button(top, text="-", command=lambda: self._resize(-5)).pack(
            side="left")
        tk.Button(top, text="+", command=lambda: self._resize(+5)).pack(
            side="left")

        paths = tk.Frame(root)
        paths.pack(fill="x")
        for row, (label, attr) in enumerate((
                ("Path to Ventilation DICOM:", "dicom_path"),
                ("Path to Mask Folder:", "mask_path"),
                ("Path to Proton:", "proton_path"),
                ("Path to Twix:", "twix_path"))):
            tk.Label(paths, text=label).grid(row=row, column=0, sticky="w")
            var = tk.StringVar(value=getattr(self.c.state, attr))
            tk.Entry(paths, textvariable=var, width=80).grid(
                row=row, column=1, sticky="we")
            self._path_vars[attr] = var

        actions = tk.Frame(root)
        actions.pack(fill="x")
        self._buttons = {}
        for key, text, cmd in (
                ("initialize", "Load from Paths", self._on_initialize),
                ("calcvdp", "Calculate VDP", self._on_vdp),
                ("calcci", "Calculate CI", self._on_ci),
                ("runtwix", "Import TWIX", self._on_twix),
                ("export", "Export Data", self._on_export)):
            b = tk.Button(actions, text=text, command=cmd)
            b.pack(side="left")
            self._buttons[key] = b
        tk.Button(actions, text="Load Pickle", command=self._on_pickle).pack(
            side="left")
        tk.Button(actions, text="Clear Cache", command=self._on_clear).pack(
            side="right")

        irb = tk.Frame(root)
        irb.pack(fill="x")
        self.irb_var = tk.StringVar(value="")
        for name, label in (("genxe", "GenXe"), ("mepo", "Mepo"),
                            ("clinical", "Clinical")):
            tk.Radiobutton(irb, text=label, value=name,
                           variable=self.irb_var,
                           command=self._on_irb).pack(side="left")
        self._study_frames = {}
        self._study_vars = {}
        for name, fields in (
                ("genxe", (("General Xenon ID:", "genxe_id"),
                           ("Disease:", "disease"),
                           ("Treatment:", "genxe_treatment"))),
                ("mepo", (("Mepo ID:", "mepo_id"),
                          ("Mepo Subject #:", "mepo_subject"),
                          ("Visit (1/2/3):", "mepo_visit"),
                          ("Treatment (preAlb/postAlb):", "mepo_treatment"))),
                ("clinical", (("Clinical Subject Initials:", "clinical_id"),
                              ("Visit #:", "clinical_visit"),
                              ("Treatment (baseline/Albuterol):",
                               "clinical_treatment")))):
            f = tk.Frame(irb)
            self._study_frames[name] = f
            for col, (label, attr) in enumerate(fields):
                tk.Label(f, text=label).grid(row=0, column=2 * col)
                var = tk.StringVar(value=getattr(self.c.state, attr))
                tk.Entry(f, textvariable=var, width=10).grid(
                    row=0, column=2 * col + 1)
                self._study_vars[attr] = var
        dose = tk.Frame(root)
        dose.pack(fill="x")
        for label, attr in (("DE [mL]:", "de"), ("FEV1 [%]:", "fev1"),
                            ("FVC [%]:", "fvc")):
            tk.Label(dose, text=label).pack(side="left")
            var = tk.StringVar(value=getattr(self.c.state, attr))
            tk.Entry(dose, textvariable=var, width=8).pack(side="left")
            self._study_vars[attr] = var

        mid = tk.Frame(root)
        mid.pack(fill="both", expand=True)
        data = tk.Frame(mid)
        data.pack(side="left", anchor="n")
        self._data_labels = {}
        for key in DATA_KEYS:
            lbl = tk.Label(data, text="", anchor="w")
            lbl.pack(fill="x")
            self._data_labels[key] = lbl
        panes = tk.Frame(mid)
        panes.pack(side="left", fill="both", expand=True)
        self._pane_labels = {}
        for key in IMAGE_PANES:
            row = tk.Frame(panes)
            row.pack(fill="x")
            tk.Label(row, text=PANE_LABELS[key], width=12,
                     anchor="w").pack(side="left")
            img = tk.Label(row)
            img.pack(side="left")
            self._pane_labels[key] = img

        bottom = tk.Frame(root)
        bottom.pack(fill="x")
        tk.Label(bottom, text="Notes:").pack(side="left")
        self.notes_var = tk.StringVar(value=self.c.state.notes)
        tk.Entry(bottom, textvariable=self.notes_var, width=80).pack(
            side="left", fill="x", expand=True)
        self.status_label = tk.Label(root, text="", anchor="w")
        self.status_label.pack(fill="x")
        # paint in-progress statuses immediately — actions run synchronously
        # on the Tk main thread, so without this the "blue" texts the
        # controller sets at action start would never be seen
        self.c.on_status = self._paint_status
        exp = tk.Frame(root)
        exp.pack(fill="x")
        tk.Label(exp, text="Export Path:").pack(side="left")
        self.export_var = tk.StringVar(value=self.c.state.export_path)
        tk.Entry(exp, textvariable=self.export_var, width=60).pack(
            side="left", fill="x", expand=True)
        self.archive_var = tk.IntVar(value=int(self.c.state.archive))
        tk.Checkbutton(exp, text="Copy pickle to Archive",
                       variable=self.archive_var).pack(side="left")
        self.refresh()

    # ---- event plumbing ----------------------------------------------------
    def _pull_state(self) -> None:
        """Copy widget variables into controller state before an action."""
        s = self.c.state
        for attr, var in self._path_vars.items():
            setattr(s, attr, var.get())
        for attr, var in self._study_vars.items():
            setattr(s, attr, var.get())
        s.user = self.user_var.get()
        s.notes = self.notes_var.get()
        s.export_path = self.export_var.get()
        s.archive = bool(self.archive_var.get())

    def _paint_status(self, status) -> None:
        self.status_label.config(text=status.text, fg=status.color)
        self.root.update_idletasks()

    def _run(self, action) -> None:
        self._pull_state()
        action()
        self.refresh()

    def _on_initialize(self):
        self._run(self.c.load_from_paths)

    def _on_vdp(self):
        self._run(self.c.calculate_vdp)

    def _on_ci(self):
        self._run(self.c.calculate_ci)

    def _on_twix(self):
        self._run(self.c.import_twix)

    def _on_export(self):
        self._run(self.c.export)

    def _on_clear(self):
        def clear():
            self.c.clear_cache()
            self.notes_var.set("")
            self.irb_var.set("")
        self._run(clear)

    def _on_pickle(self):
        ask = self._ask_string
        if ask is None:
            from tkinter import simpledialog

            ask = lambda title, prompt: simpledialog.askstring(title, prompt)
        path = ask("Load Pickle", "Enter Pickle Path:")
        if path:
            self._run(lambda: self.c.load_pickle(path))

    def _on_irb(self):
        self.c.select_irb(self.irb_var.get() or None)
        self.refresh()

    def _resize(self, delta: int):
        self.c.state.image_box_size = max(
            10, self.c.state.image_box_size + delta)
        self.refresh()

    # ---- paint -------------------------------------------------------------
    def refresh(self) -> None:
        self.status_label.config(text=self.c.status.text,
                                 fg=self.c.status.color)
        for key, btn in self._buttons.items():
            btn.config(bg=self.c.buttons[key])
        for name, frame in self._study_frames.items():
            if self.c.irb_panel_visible[name]:
                frame.pack(side="left")
            else:
                frame.pack_forget()
        summary = self.c.data_summary()
        for key, lbl in self._data_labels.items():
            lbl.config(text=summary.get(key, ""))
        panes = self.c.pane_images()
        for key, lbl in self._pane_labels.items():
            photo = self._photo(panes[key], self.c.state.image_box_size)
            self._photos[key] = photo
            lbl.config(image=photo)


def launch(controller: Optional[VentController] = None) -> None:
    """Open the window and run the event loop (``python -m ventjax_torch
    gui``).  Where tkinter itself is missing it raises GuiUnavailableError
    too."""
    try:
        import tkinter as tk
    except ImportError as e:
        raise GuiUnavailableError(
            f"no display available for the ventjax_torch GUI: tkinter does "
            f"not import ({e}); use `python -m ventjax_torch analyze`") from e

    try:
        root = tk.Tk()
    except tk.TclError as e:
        raise GuiUnavailableError(
            "no display available for the ventjax_torch GUI (tkinter said: "
            f"{e}); on a headless machine use `python -m ventjax_torch "
            "analyze` or forward X11") from e
    VentApp(root, controller)
    root.mainloop()
