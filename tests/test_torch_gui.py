"""The port's GUI (ventjax_torch/gui) against ventjax's, headless, on the
CPU.

Every case of tests/test_gui.py (the controller) and tests/test_gui_view.py
(the tkinter view through a fake toolkit) runs against both controllers,
ventjax's and the port's (``device="cpu"``), on the same write_study
inputs, with the same expectations: status texts and colours, button
states, export files and filename grammar.  Then one flow through both
controllers side by side: the same status sequence and button states, the
same filenames, VDPs within 0.1 pp and the CI map equal where the defect
arrays agree.  The port's CLI ``gui`` exits without a display as
ventjax's does.
"""
import importlib
import os
import types

import numpy as np
import pytest

PKGS = ["ventjax", "ventjax_torch"]


def _gui(pkg):
    """(controller module, app module, FAST_CFG) of one package."""
    ctl = importlib.import_module(f"{pkg}.gui.controller")
    app = importlib.import_module(f"{pkg}.gui.app")
    cfg = importlib.import_module(f"{pkg}.config").DEFAULT_CONFIG.replace(
        ci_max_defect_voxels=1024)
    return ctl, app, cfg


def controller(pkg, state=None, config=False):
    ctl, _, cfg = _gui(pkg)
    kw = {"device": "cpu"} if pkg == "ventjax_torch" else {}
    return ctl.VentController(state, config=cfg if config else None, **kw)


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


@pytest.fixture(scope="module")
def study_root(tmp_path_factory):
    from ventjax_torch.io.synthetic import write_study

    root = tmp_path_factory.mktemp("gui_study")
    write_study(str(root), shape=(64, 64, 8), vox=(1.5, 1.5, 10.0), seed=6)
    return str(root)


def _state(pkg, study_root, out):
    ctl, _, _ = _gui(pkg)
    return ctl.GuiState(
        dicom_path=f"{study_root}/xenon.dcm",
        mask_path=f"{study_root}/mask",
        proton_path=f"{study_root}/proton.dcm",
        export_path=str(out),
    )


@pytest.fixture()
def ctl(pkg, study_root, tmp_path):
    return controller(pkg, _state(pkg, study_root, tmp_path / "out"),
                      config=True)


def _idle_done(pkg):
    ctl, _, _ = _gui(pkg)
    return ctl.IDLE, ctl.DONE


# ---------------------------------------------------------------------------
# tests/test_gui.py's cases, on both controllers


def test_initial_state_blank_panes(pkg):
    idle, _ = _idle_done(pkg)
    c = controller(pkg)
    assert c.buttons == {b: idle for b in c.buttons}
    panes = c.pane_images()
    assert set(panes) == {"twix", "proton", "raw", "n4", "defect", "ci"}
    for p in panes.values():
        assert p.shape == (3, 3, 3) and not p.any()
    assert c.data_summary() == {}


def test_load_error_status_matches_reference(pkg):
    ctl, _, _ = _gui(pkg)
    idle, _ = _idle_done(pkg)
    c = controller(pkg, ctl.GuiState(dicom_path="/nope.dcm",
                                     mask_path="/nope"))
    assert not c.load_from_paths()
    assert c.status.color == "red"
    assert c.status.text.startswith("ERROR: Uhh you messed something up.")
    assert c.buttons["initialize"] == idle and c.study is None


def test_full_flow_load_vdp_ci(pkg, ctl):
    _, done = _idle_done(pkg)
    assert ctl.load_from_paths()
    assert (ctl.status.text, ctl.status.color) == (
        "Vent_Analysis loaded", "green")
    assert ctl.buttons["initialize"] == done

    summary = ctl.data_summary()
    assert summary["subject"] == "Subject: VENTJAX^PHANTOM"
    assert summary["vox"] == "DICOM voxel Size: [1.5, 1.5, 10.0] [mm]"
    assert summary["ventarrayshape"] == "Ventilation Array Shape: (64, 64, 8)"

    panes = ctl.pane_images()
    assert panes["proton"].shape[0] > 3 and panes["raw"].shape[0] > 3
    assert panes["n4"].shape == (3, 3, 3)

    assert ctl.calculate_vdp()
    assert (ctl.status.text, ctl.status.color) == ("VDP Calculated", "green")
    assert ctl.buttons["calcvdp"] == done
    vdp = float(ctl.study.metadata["VDP"])
    assert 0 < vdp < 50
    assert ctl.pane_images()["defect"].shape[0] > 3

    assert ctl.calculate_ci()
    assert ctl.status.text == "CI Calculated successfully"
    assert ctl.buttons["calcci"] == done
    assert ctl.pane_images()["ci"].shape[0] > 3
    assert "CI:" in ctl.data_summary()["ci"]


def test_calc_before_load_is_red_not_crash(pkg):
    c = controller(pkg)
    assert not c.calculate_vdp()
    assert c.status.color == "red" and "VDP" in c.status.text
    assert not c.calculate_ci()
    assert c.status.color == "red"


def test_export_validations_and_grammar(pkg, ctl, tmp_path):
    _, done = _idle_done(pkg)
    ctl.load_from_paths()
    ctl.calculate_vdp()

    assert not ctl.export(today="250101")
    assert ctl.status.text.startswith("Don't forget to enter your Name")
    assert not os.path.exists(ctl.state.export_path)

    ctl.state.user = "RPT"
    assert not ctl.export(today="250101")
    assert ctl.status.text.startswith("Don't forget to select an IRB!")

    ctl.select_irb("mepo")
    ctl.state.mepo_id = "0039"
    ctl.state.mepo_visit = "2"
    ctl.state.mepo_treatment = "preAlb"
    ctl.state.de, ctl.state.fev1, ctl.state.fvc = "1000", "85", "90"
    ctl.state.notes = "gui test"
    assert ctl.export(today="250101")
    assert ctl.status.color == "orange"
    assert "Exported but not Archived" in ctl.status.text
    assert ctl.buttons["export"] == done

    base = "Mepo0039_240301_visit2_preAlb"
    exp_dir = os.path.join(ctl.state.export_path, "VentAnalysis_RPT_250101")
    files = set(os.listdir(exp_dir))
    assert {f"{base}.json", f"{base}.pkl", f"{base}.png",
            f"{base}_dataArray.nii", "defectDICOMS"} <= files
    md = ctl.study.metadata
    assert md["fileName"] == base and md["IRB"] == "mepo"
    assert md["visit"] == 2 and md["treatment"] == "preAlb"
    assert (md["DE"], md["FEV1"], md["FVC"]) == ("1000", "85", "90")
    assert md["notes"] == "gui test" and md["analysisUser"] == "RPT"

    arch = tmp_path / "archive"
    arch.mkdir()
    ctl.state.archive_path = str(arch)
    assert ctl.export(today="250101")
    assert ctl.status.color == "green"
    assert "Exported and Archived" in ctl.status.text
    assert (arch / f"{base}.pkl").exists()


def test_export_filename_genxe_and_clinical(ctl):
    ctl.load_from_paths()
    ctl.select_irb("genxe")
    ctl.state.genxe_id = "0123"
    ctl.state.genxe_treatment = "postSildenafil"
    assert ctl.export_filename() == "Xe-0123_240301_postSil"

    ctl.select_irb("clinical")
    ctl.state.clinical_id = "AB"
    ctl.state.clinical_visit = "3"
    ctl.state.clinical_treatment = "Albuterol"
    assert ctl.export_filename() == "Clinical_AB_240301_visit3_Albuterol"
    ctl.state.clinical_treatment = "baseline"
    assert ctl.export_filename() == "Clinical_AB_240301_visit3_baseline"
    ctl.state.clinical_treatment = ""
    assert ctl.export_filename() == "Clinical_AB_240301_visit3"


def test_import_twix_pane_and_labels(pkg, ctl, tmp_path):
    from ventjax_torch.io.twix import write_synthetic_twix

    _, done = _idle_done(pkg)
    rng = np.random.default_rng(1)
    k = (rng.normal(size=(32, 32, 4)) +
         1j * rng.normal(size=(32, 32, 4))).astype(np.complex64)
    dat = str(tmp_path / "meas.dat")
    write_synthetic_twix(dat, k, protocol_name="vent_gre")
    ctl.load_from_paths()
    ctl.state.twix_path = dat
    assert ctl.import_twix()
    assert ctl.status.text == "TWIX Processed successfully"
    assert ctl.buttons["runtwix"] == done
    assert ctl.pane_images()["twix"].shape[0] > 3
    assert "vent_gre" in ctl.data_summary()["twixprotocol"]

    ctl.state.twix_path = "/no/such.dat"
    assert not ctl.import_twix()
    assert ctl.status.color == "red" and "TWIX" in ctl.status.text


def test_edit_metadata_and_clear_cache(pkg, ctl):
    idle, _ = _idle_done(pkg)
    ctl.load_from_paths()
    ctl.edit_metadata("PatientName", "EDITED^NAME")
    assert ctl.data_summary()["subject"] == "Subject: EDITED^NAME"

    ctl.select_irb("mepo")
    ctl.state.notes = "scratch"
    ctl.clear_cache()
    assert ctl.study is None and ctl.state.irb is None
    assert ctl.state.notes == ""
    assert all(v == idle for v in ctl.buttons.values())
    assert ctl.status.color == "blue"
    assert ctl.irb_panel_visible == {
        "genxe": False, "mepo": False, "clinical": False}


def test_pickle_round_trip_through_controller(pkg, ctl, tmp_path):
    _, done = _idle_done(pkg)
    ctl.load_from_paths()
    ctl.calculate_vdp()
    pkl = str(tmp_path / "study.pkl")
    ctl.study.pickleMe(pkl)

    c2 = controller(pkg, config=True)
    assert c2.load_pickle(pkl)
    assert c2.status.text == "Vent_Analysis pickle loaded"
    assert c2.buttons["initialize"] == done
    np.testing.assert_allclose(
        float(c2.study.metadata["VDP"]), float(ctl.study.metadata["VDP"]))

    assert not c2.load_pickle("/no/such.pkl")
    assert c2.status.color == "red"


def test_irb_selection_controls_panels(pkg):
    c = controller(pkg)
    with pytest.raises(ValueError):
        c.select_irb("bogus")
    c.select_irb("genxe")
    assert c.irb_panel_visible == {
        "genxe": True, "mepo": False, "clinical": False}


def test_view_module_imports_headless(pkg, monkeypatch):
    """The view imports, and refuses cleanly, without a display."""
    _, app, _ = _gui(pkg)
    assert hasattr(app, "VentApp") and hasattr(app, "launch")
    monkeypatch.delenv("DISPLAY", raising=False)
    with pytest.raises(app.GuiUnavailableError):
        app.launch()


def test_cli_gui_subcommand_headless(pkg, monkeypatch, capsys):
    """``gui`` without a display: exit 2 and ventjax's message."""
    main = importlib.import_module(f"{pkg}.cli").main
    monkeypatch.delenv("DISPLAY", raising=False)
    rc = main(["gui", "--xenon", "/x.dcm", "--mask", "/m"])
    assert rc == 2
    err = capsys.readouterr().err
    assert err.startswith("error: no display available for the ") and \
        "GUI (tkinter said: " in err


def test_status_observer_sees_in_progress_blue(pkg):
    seen = []
    c = controller(pkg)
    c.on_status = lambda s: seen.append((s.text, s.color))
    c.calculate_vdp()   # no study loaded: red, after the blue
    assert seen[0] == ("Calculating VDP...", "blue")
    assert seen[-1][1] == "red"


# ---------------------------------------------------------------------------
# tests/test_gui_view.py's cases, through a fake toolkit, on both views


class FakeVar:
    def __init__(self, value=""):
        self._v = value

    def get(self):
        return self._v

    def set(self, value):
        self._v = value


class FakeWidget:
    def __init__(self, master=None, **kw):
        self.master = master
        self.kw = dict(kw)
        self.packed = None
        self.gridded = None

    def pack(self, **kw):
        self.packed = kw

    def pack_forget(self):
        self.packed = None

    def grid(self, **kw):
        self.gridded = kw

    def config(self, **kw):
        self.kw.update(kw)

    configure = config

    def invoke(self):
        self.kw["command"]()


class FakeRoot(FakeWidget):
    def __init__(self):
        super().__init__()
        self.titles = []
        self.idle_flushes = 0

    def title(self, text):
        self.titles.append(text)

    def update_idletasks(self):
        self.idle_flushes += 1


def make_fake_tk():
    tk = types.SimpleNamespace()
    tk.StringVar = lambda value="": FakeVar(value)
    tk.IntVar = lambda value=0: FakeVar(value)
    for name in ("Frame", "Label", "Entry", "Button", "Radiobutton",
                 "Checkbutton"):
        setattr(tk, name, type(name, (FakeWidget,), {}))
    return tk


def fake_photo(arr, box):
    return ("photo", np.asarray(arr).shape, box)


def make_app(pkg, study_root, out, ask_string=None):
    _, app, _ = _gui(pkg)
    c = controller(pkg, _state(pkg, study_root, out / "out"), config=True)
    root = FakeRoot()
    return app.VentApp(root, c, tk_module=make_fake_tk(),
                       photo_factory=fake_photo, ask_string=ask_string), root


def _files_under(out_root):
    found = []
    for base, _, files in os.walk(out_root):
        found += [os.path.join(base, f) for f in files]
    return found


def _fill_export_fields(app):
    app.user_var.set("RPT")
    app.irb_var.set("mepo")
    app._on_irb()
    app._study_vars["mepo_id"].set("0039")
    app._study_vars["mepo_visit"].set("2")
    app._study_vars["mepo_treatment"].set("preAlb")
    app.archive_var.set(0)


def test_window_builds_and_initial_paint(pkg, study_root, tmp_path):
    _, app_mod, _ = _gui(pkg)
    app, root = make_app(pkg, study_root, tmp_path)
    assert root.titles and root.titles[0].startswith(
        f"{pkg} Ventilation Analysis -- ")
    assert set(app._pane_labels) == set(app_mod.IMAGE_PANES)
    for key in app_mod.IMAGE_PANES:
        photo = app._photos[key]
        assert photo[0] == "photo" and photo[2] == app.c.state.image_box_size
    assert set(app._data_labels) == set(app_mod.DATA_KEYS)
    assert all(f.packed is None for f in app._study_frames.values())


def test_button_flow_load_vdp_ci_export(pkg, study_root, tmp_path):
    app, _ = make_app(pkg, study_root, tmp_path)
    b = app._buttons
    b["initialize"].invoke()
    assert "loaded" in app.status_label.kw["text"]
    assert app.status_label.kw["fg"] == "green"
    b["calcvdp"].invoke()
    assert app.c.study is not None
    assert "VDP" in app._data_labels["vdp"].kw["text"]
    b["calcci"].invoke()
    assert "CI" in app._data_labels["ci"].kw["text"]
    for key in ("raw", "n4", "defect", "ci"):
        assert app._photos[key][0] == "photo"
    b["export"].invoke()
    assert app.status_label.kw["fg"] == "red"
    assert app.status_label.kw["text"].startswith("Don't forget")
    _fill_export_fields(app)
    b["export"].invoke()
    assert app.status_label.kw["fg"] == "green", app.status_label.kw
    files = _files_under(app.export_var.get())
    assert any(f.endswith(".pkl") for f in files)
    assert any(f.endswith("_dataArray.nii") for f in files)


def test_pull_state_copies_widget_vars(pkg, study_root, tmp_path):
    app, _ = make_app(pkg, study_root, tmp_path)
    app.user_var.set("RPT")
    app.notes_var.set("severe case")
    app._path_vars["twix_path"].set("/nope.dat")
    app._buttons["initialize"].invoke()
    assert app.c.state.user == "RPT"
    assert app.c.state.notes == "severe case"
    assert app.c.state.twix_path == "/nope.dat"


def test_irb_radio_toggles_study_frames(pkg, study_root, tmp_path):
    app, _ = make_app(pkg, study_root, tmp_path)
    app.irb_var.set("mepo")
    app._on_irb()
    assert app._study_frames["mepo"].packed is not None
    assert app._study_frames["genxe"].packed is None
    app.irb_var.set("genxe")
    app._on_irb()
    assert app._study_frames["genxe"].packed is not None
    assert app._study_frames["mepo"].packed is None


def test_resize_buttons_change_pane_box(pkg, study_root, tmp_path):
    app, _ = make_app(pkg, study_root, tmp_path)
    before = app.c.state.image_box_size
    app._resize(+5)
    assert app._photos["raw"][2] == before + 5
    app._resize(-5)
    assert app._photos["raw"][2] == before
    for _ in range(60):
        app._resize(-5)
    assert app.c.state.image_box_size == 10


def test_in_progress_status_paints_immediately(pkg, study_root, tmp_path):
    app, root = make_app(pkg, study_root, tmp_path)
    seen = []
    orig = app._paint_status

    def spy(status):
        orig(status)
        seen.append((status.text, status.color))

    app.c.on_status = spy
    app._buttons["initialize"].invoke()
    app._buttons["calcvdp"].invoke()
    assert any(c == "blue" for _, c in seen), seen
    assert root.idle_flushes >= len(seen)


def test_load_pickle_dialog_path(pkg, study_root, tmp_path):
    app, _ = make_app(pkg, study_root, tmp_path)
    for key in ("initialize", "calcvdp"):
        app._buttons[key].invoke()
    _fill_export_fields(app)
    app._buttons["export"].invoke()
    pkl = next(f for f in _files_under(app.export_var.get())
               if f.endswith(".pkl"))
    app2, _ = make_app(pkg, study_root, tmp_path / "second",
                       ask_string=lambda title, prompt: pkl)
    app2._on_pickle()
    assert app2.c.study is not None
    assert app2.status_label.kw["fg"] == "green"
    app3, _ = make_app(pkg, study_root, tmp_path / "third",
                       ask_string=lambda title, prompt: None)
    app3._on_pickle()
    assert app3.c.study is None


def test_clear_cache_resets_vars(pkg, study_root, tmp_path):
    app, _ = make_app(pkg, study_root, tmp_path)
    app.notes_var.set("something")
    app.irb_var.set("mepo")
    app._buttons["initialize"].invoke()
    app._on_clear()
    assert app.notes_var.get() == ""
    assert app.irb_var.get() == ""
    assert app.c.study is None


# ---------------------------------------------------------------------------
# Both controllers side by side


def _flow(pkg, study_root, out):
    """Every event of a session on one controller: the status after each
    (and every status the observer saw), the buttons, the export files and
    the study."""
    c = controller(pkg, _state(pkg, study_root, out), config=True)
    seen = []
    c.on_status = lambda s: seen.append((s.text, s.color))
    steps = []

    def step(name, ok):
        steps.append((name, ok, c.status.text, c.status.color,
                      dict(c.buttons)))

    step("load", c.load_from_paths())
    step("vdp", c.calculate_vdp())
    step("ci", c.calculate_ci())
    step("export_no_user", c.export(today="250101"))
    c.state.user = "RPT"
    step("export_no_irb", c.export(today="250101"))
    c.select_irb("clinical")
    c.state.clinical_id, c.state.clinical_visit = "AB", "3"
    c.state.clinical_treatment = "Albuterol"
    step("export", c.export(today="250101"))
    names = ["genxe", "mepo", "clinical"]
    grammar = []
    for irb in names:
        c.select_irb(irb)
        grammar.append(c.export_filename())
    files = sorted(os.path.relpath(f, out) for f in _files_under(out))
    return c, steps, seen, files, grammar


def test_both_controllers_agree(study_root, tmp_path):
    """The same statuses, colours and buttons after every event, the same
    transient statuses, the same files and filenames; VDPs within 0.1 pp;
    the defect arrays equal and the CI map equal to float32 rounding where
    they agree."""
    jc, jsteps, jseen, jfiles, jgram = _flow("ventjax", study_root,
                                             tmp_path / "j")
    tc, tsteps, tseen, tfiles, tgram = _flow("ventjax_torch", study_root,
                                             tmp_path / "t")
    assert tsteps == jsteps
    assert tseen == jseen
    assert tfiles == jfiles
    assert tgram == jgram
    assert jsteps[-1][1:4] == (True, "Data Successfully Exported but not "
                               "Archived...", "orange")
    jmd, tmd = jc.study.metadata, tc.study.metadata
    for key in ("VDP", "VDP_lb", "VDP_km"):
        assert abs(float(tmd[key]) - float(jmd[key])) < 0.1, key
    assert tmd["fileName"] == jmd["fileName"] == \
        "Clinical_AB_240301_visit3_Albuterol"
    same_defect = np.array_equal(tc.study.defectArray, jc.study.defectArray)
    assert same_defect
    np.testing.assert_allclose(tc.study.CIarray, jc.study.CIarray,
                               rtol=0, atol=2e-5)
    assert abs(float(tmd["CI"]) - float(jmd["CI"])) <= 2e-5
    assert tc.study.device.type == "cpu"
