"""The port's web app (``conzic_torch/api/app.py``, ``api/fallback_ui.py``)
against ``conzic_tpu``'s, on the CPU.

The app tests of ``tests/test_cli.py``, on the port: the Submit callback in
caption and controllable mode gives the strings of the reference's
``make_demo_fn`` for the same seed and weights (``trained_tiny/``, fp32),
the widget logic is the reference's, and the stdlib fallback server serves
the widget page and answers a POST with the callback's strings. Also
``format_output`` and the entry point's device and UI choices.
"""

import base64
import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from conzic_tpu.api import app as jax_app
from conzic_tpu.config import ConzicConfig as JaxConfig
from conzic_torch import compat
from conzic_torch.api import app, fallback_ui
from conzic_torch.config import ConzicConfig
from test_torch_engine import _base_pair

WIDGETS = ("Run Type", "Control Type", "Sentiment", "Generation Order",
           "Prompt", "Sentence Length", "Num Iterations", "Samples", "Alpha",
           "Beta", "Gamma", "Upload Picture", "Final Caption", "Best Caption",
           "Submit", "Reset")


def _image():
    return Image.fromarray(np.random.RandomState(0).randint(
        0, 255, (64, 48, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def demo_fns():
    """(reference, port) Submit callbacks over trained_tiny/ in fp32,
    k=6."""
    jc, pc = _base_pair("trained_tiny")
    jcfg, pcfg = JaxConfig(candidate_k=6), ConzicConfig(candidate_k=6)
    for cap in (jc, pc):
        cap.cfg.verbose = False
    return (jax_app.make_demo_fn(jc, jcfg), app.make_demo_fn(pc, pcfg))


# (run_type, control_type, sentiment_type, order, samples_num)
CASES = [
    ("caption", "sentiment", "positive", "sequential", 2),
    ("caption", "sentiment", "positive", "shuffle", 1),
    ("controllable", "sentiment", "negative", "sequential", 1),
    ("controllable", "pos", "positive", "sequential", 1),
]


@pytest.mark.parametrize("run_type,control,sentiment,order,samples", CASES)
def test_app_callback_matches_reference(demo_fns, run_type, control,
                                        sentiment, order, samples):
    args = (run_type, control, sentiment, order, "Image of a", 4, 1, samples,
            0.02, 2.0, 5.0, _image())
    want = demo_fns[0](*args)
    got = demo_fns[1](*args)
    assert got == want
    final, best = got
    assert len(final.splitlines()) == samples and best


def test_app_widget_logic_matches_reference():
    for rt in ("controllable", "caption"):
        assert (app.control_widgets_visible(rt)
                == jax_app.control_widgets_visible(rt))
    for ct in ("sentiment", "pos"):
        assert (app.sentiment_widget_visible(ct)
                == jax_app.sentiment_widget_visible(ct))
    assert app.control_widgets_visible("controllable")
    assert not app.sentiment_widget_visible("pos")
    assert app.reset_values() == jax_app.reset_values()
    assert app.reset_values()[5:8] == (10, 10, 2)


def test_format_output_variants():
    finals = [f"f{i}" for i in range(5)]
    bests = [f"b{i}" for i in range(5)]
    for fn in (app.format_output, compat.format_output):
        assert fn(1, finals, bests) == ("f0", "b0")
        assert fn(3, finals, bests) == ("f0\nf1\nf2", "b0\nb1\nb2")
        assert fn(5, finals, bests)[0].count("\n") == 4
        assert fn(0, finals, bests) == ("f0", "b0")
        assert fn(9, finals[:2], bests[:2]) == ("f0\nf1", "b0\nb1")
        for n in (0, 1, 3, 9):
            assert fn(n, finals, bests) == jax_app.format_output(
                n, finals, bests)


def _post(conn, path, payload):
    conn.request("POST", path, body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read()


def test_fallback_ui_server_serves_and_submits(demo_fns):
    """GET / returns the widget page; POST /submit runs the Submit
    callback and returns the reference's strings; a bad request is
    answered with an error and the server goes on."""
    _, pc = _base_pair("trained_tiny")
    cfg = ConzicConfig(candidate_k=6)
    server = fallback_ui.make_server(pc, cfg, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("GET", "/")
        resp = conn.getresponse()
        page = resp.read().decode("utf-8")
        assert resp.status == 200
        for widget in WIDGETS:
            assert widget in page, widget
        assert page == fallback_ui.render_page(cfg)
        assert f'value="{cfg.alpha}"' in page
        buf = io.BytesIO()
        _image().save(buf, format="PNG")
        payload = {
            "run_type": "caption", "control_type": "sentiment",
            "sentiment_type": "positive", "order": "sequential",
            "prompt": "Image of a", "sentence_len": 4,
            "num_iterations": 1, "samples_num": 2,
            "alpha": 0.02, "beta": 2.0, "gamma": 5.0,
            "image": "data:image/png;base64,"
                     + base64.b64encode(buf.getvalue()).decode(),
        }
        status, body = _post(conn, "/submit", payload)
        out = json.loads(body)
        assert status == 200
        want = demo_fns[0]("caption", "sentiment", "positive", "sequential",
                           "Image of a", 4, 1, 2, 0.02, 2.0, 5.0,
                           Image.open(io.BytesIO(buf.getvalue())))
        assert (out["final"], out["best"]) == want
        status, body = _post(conn, "/submit", {"run_type": "caption"})
        assert status == 500 and "error" in json.loads(body)
        status, _ = _post(conn, "/nowhere", payload)
        assert status == 404
        conn.request("GET", "/nowhere")
        assert conn.getresponse().status == 404
    finally:
        server.shutdown()
        server.server_close()


def test_app_main_picks_the_ui_and_the_device(monkeypatch):
    served = {}
    monkeypatch.setattr(fallback_ui, "serve", lambda cap, cfg, port: (
        served.update(cap=cap, cfg=cfg, port=port)))
    app.main(["--random_models", "tiny", "--device", "cpu", "--ui",
              "fallback", "--port", "7999"])
    assert served["cap"].device == torch.device("cpu")
    assert served["port"] == 7999
    try:
        import gradio  # noqa: F401
    except ImportError:
        with pytest.raises(SystemExit, match="gradio is not installed"):
            app.main(["--random_models", "tiny", "--device", "cpu",
                      "--ui", "gradio"])
        served.clear()
        app.main(["--random_models", "tiny", "--device", "cpu"])
        assert served["port"] == 7860  # auto: the fallback server
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            app.main(["--random_models", "tiny", "--ui", "fallback"])
