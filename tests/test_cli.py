"""CLI smoke tests (render / sweep / fit / vtp converter) on tiny configs."""

import json
import os

import numpy as np
import pytest

SCENE = os.path.join(os.path.dirname(__file__), "..", "assets", "sphere", "sphere.scene")


def test_render_cli(tmp_path, capsys):
    from mcray_tpu.cli import main

    out = str(tmp_path / "b.png")
    assert main([SCENE, "--elements", "16", "--samples", "1", "--out", out]) == 0
    assert os.path.exists(out)
    text = capsys.readouterr().out
    assert "saved" in text


def test_render_cli_dump_column(tmp_path, capsys):
    """--dump-column prints one scanline row-by-row (the reference's
    rf_image::print, src/rfimage.h:166-173)."""
    from mcray_tpu.cli import main

    out = str(tmp_path / "b.png")
    assert main([SCENE, "--elements", "16", "--samples", "1", "--out", out,
                 "--dump-column", "3"]) == 0
    text = capsys.readouterr().out
    assert "RF column 3" in text
    assert "   0: " in text


def test_sweep_cli(tmp_path):
    from mcray_tpu.cli import main

    prefix = str(tmp_path / "sw")
    assert main([
        "sweep", SCENE, "--frames", "2", "--elements", "16", "--samples", "1",
        "--out-prefix", prefix, "--delta-pos", "0", "0.5", "0",
    ]) == 0
    from mcray_tpu.utils.image_io import load_png

    a = load_png(prefix + "_000.png").astype(float)
    b = load_png(prefix + "_001.png").astype(float)
    assert a.shape == b.shape
    assert np.abs(a - b).max() > 0


def test_fit_cli(tmp_path, capsys):
    from mcray_tpu.cli import main

    ckpt = str(tmp_path / "fit.npz")
    assert main([
        "fit", SCENE, "--material", "LIVER", "--param", "attenuation",
        "--steps", "4", "--elements", "16", "--samples", "1",
        "--checkpoint", ckpt,
    ]) == 0
    assert os.path.exists(ckpt)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    result = json.loads(lines[-1])
    assert np.isfinite(result["loss_last"])


def test_vtp_converter(tmp_path):
    from mcray_tpu.utils.vtp_to_obj import main as vmain
    from mcray_tpu.scene.obj import _load_obj_py

    vtp = tmp_path / "t.vtp"
    vtp.write_text(
        '<?xml version="1.0"?><VTKFile type="PolyData"><PolyData>'
        '<Piece NumberOfPoints="4" NumberOfPolys="1"><Points>'
        '<DataArray type="Float32" NumberOfComponents="3" format="ascii">'
        "0 0 0 1 0 0 1 1 0 0 1 0</DataArray></Points><Polys>"
        '<DataArray type="Int64" Name="connectivity" format="ascii">0 1 2 3</DataArray>'
        '<DataArray type="Int64" Name="offsets" format="ascii">4</DataArray>'
        "</Polys></Piece></PolyData></VTKFile>"
    )
    obj = str(tmp_path / "t.obj")
    assert vmain([str(vtp), obj]) == 0
    v, f = _load_obj_py(obj)
    assert v.shape == (4, 3)
    assert f.shape == (2, 3)  # quad fan-triangulated


def test_serve_cli(tmp_path, capsys, monkeypatch):
    """One request per stdin line -> one JSON response + PNG per frame,
    with pipelined dispatch across frames."""
    import io

    from mcray_tpu.cli import main

    out0 = str(tmp_path / "s0.png")
    out1 = str(tmp_path / "s1.png")
    requests = (
        json.dumps({"seed": 1, "out": out0})
        + "\n"
        + json.dumps({"position": [0.0, -13.0, 0.0], "out": out1})
        + "\nnot json\n"
    )
    monkeypatch.setattr("sys.stdin", io.StringIO(requests))
    assert main(["serve", SCENE, "--elements", "16", "--samples", "1"]) == 0
    assert os.path.exists(out0) and os.path.exists(out1)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert lines[0]["ready"] is True
    frames = [l for l in lines if "frame" in l]
    assert [f["out"] for f in frames] == [out0, out1]
    assert any("error" in l for l in lines)  # bad request reported, not fatal
