"""The web UI without gradio: ``conzic-torch-app --ui fallback``.

Counterpart of ``conzic_tpu/api/fallback_ui.py`` (vendored: the page and
the server are the reference's). The reference's UI is a Gradio Blocks app;
where gradio is not installed, ``api.app`` serves this stdlib
``http.server`` page with the same widgets: run-type radio, the control
widgets with the reference's visibility rules, the sliders, image upload,
Submit and Reset, and the two output boxes joined by ``format_output``.
Submit runs the same ``make_demo_fn`` closure as the gradio path: one
captioner, loaded once, serves every request.

The browser posts JSON (the image as a base64 data URL) to ``/submit``;
one generation runs at a time.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from conzic_torch.config import ConzicConfig

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8">
<title>ConZIC</title>
<style>
 body { font-family: sans-serif; margin: 2em; max-width: 60em; }
 .row { display: flex; gap: 2em; }
 .col { flex: 1; }
 label { display: block; margin-top: .8em; font-weight: bold; }
 textarea { width: 100%; height: 8em; }
 .hidden { display: none; }
 button { margin-top: 1em; margin-right: 1em; padding: .5em 1.5em; }
 #status { color: #666; margin-top: 1em; }
</style></head><body>
<h1>ConZIC: Controllable Zero-shot Image Captioning</h1>
<div class="row"><div class="col">
 <label>Run Type</label>
 <input type="radio" name="run_type" value="caption" checked> caption
 <input type="radio" name="run_type" value="controllable"> controllable
 <div id="control_type_box" class="hidden">
  <label>Control Type</label>
  <input type="radio" name="control_type" value="sentiment" checked> sentiment
  <input type="radio" name="control_type" value="pos"> pos
 </div>
 <div id="sentiment_box" class="hidden">
  <label>Sentiment</label>
  <input type="radio" name="sentiment_type" value="positive" checked> positive
  <input type="radio" name="sentiment_type" value="negative"> negative
 </div>
 <label>Generation Order</label>
 <select id="order">
  <option>sequential</option><option selected>shuffle</option>
  <option>span</option><option>random</option>
 </select>
 <label>Prompt</label><input id="prompt" value="Image of a">
 <label>Sentence Length: <span id="lenv">10</span></label>
 <input type="range" id="sentence_len" min="5" max="15" step="1" value="10"
  oninput="lenv.textContent=this.value">
 <label>Num Iterations: <span id="iterv">10</span></label>
 <input type="range" id="num_iterations" min="1" max="15" step="1" value="10"
  oninput="iterv.textContent=this.value">
 <label>Samples: <span id="sampv">2</span></label>
 <input type="range" id="samples_num" min="1" max="5" step="1" value="2"
  oninput="sampv.textContent=this.value">
 <label>Alpha (weight for fluency): <span id="alphav">__ALPHA__</span></label>
 <input type="range" id="alpha" min="0" max="1" step="0.01" value="__ALPHA__"
  oninput="alphav.textContent=this.value">
 <label>Beta (weight for image-matching degree): <span id="betav">__BETA__</span></label>
 <input type="range" id="beta" min="1" max="5" step="0.5" value="__BETA__"
  oninput="betav.textContent=this.value">
 <label>Gamma (weight for controllable degree): <span id="gammav">__GAMMA__</span></label>
 <input type="range" id="gamma" min="1" max="10" step="0.5" value="__GAMMA__"
  oninput="gammav.textContent=this.value">
 <label>Upload Picture</label><input type="file" id="image" accept="image/*">
 <div>
  <button id="submit">Submit</button>
  <button id="reset">Reset</button>
 </div>
 <div id="status"></div>
</div><div class="col">
 <label>Final Caption</label>
 <textarea id="final_out" placeholder="Final Caption" readonly></textarea>
 <label>Best Caption</label>
 <textarea id="best_out" placeholder="Best Caption" readonly></textarea>
</div></div>
<script>
function radioVal(name) {
  return document.querySelector('input[name='+name+']:checked').value;
}
function setRadio(name, value) {
  document.querySelector('input[name='+name+'][value='+value+']').checked = true;
}
function updateVisibility() {
  // the reference's RunTypeChange / ControlTypeChange
  var controllable = radioVal('run_type') === 'controllable';
  document.getElementById('control_type_box').classList.toggle('hidden', !controllable);
  var senti = controllable && radioVal('control_type') === 'sentiment';
  document.getElementById('sentiment_box').classList.toggle('hidden', !senti);
}
document.querySelectorAll('input[name=run_type],input[name=control_type]')
  .forEach(function(el){ el.addEventListener('change', updateVisibility); });
document.getElementById('reset').addEventListener('click', function(){
  // the reference's Reset values
  setRadio('run_type','caption'); setRadio('control_type','sentiment');
  setRadio('sentiment_type','positive');
  order.value='shuffle'; prompt_el().value='Image of a';
  setSlider('sentence_len','lenv',10); setSlider('num_iterations','iterv',10);
  setSlider('samples_num','sampv',2); setSlider('alpha','alphav','__ALPHA__');
  setSlider('beta','betav','__BETA__'); setSlider('gamma','gammav','__GAMMA__');
  updateVisibility();
});
function prompt_el(){ return document.getElementById('prompt'); }
function setSlider(id, lab, v){
  document.getElementById(id).value = v;
  document.getElementById(lab).textContent = v;
}
document.getElementById('submit').addEventListener('click', function(){
  var f = document.getElementById('image').files[0];
  var status = document.getElementById('status');
  if (!f) { status.textContent = 'upload an image first'; return; }
  var r = new FileReader();
  r.onload = function() {
    status.textContent = 'generating…';
    fetch('/submit', {method:'POST', headers:{'Content-Type':'application/json'},
      body: JSON.stringify({
        run_type: radioVal('run_type'),
        control_type: radioVal('control_type'),
        sentiment_type: radioVal('sentiment_type'),
        order: order.value, prompt: prompt_el().value,
        sentence_len: +document.getElementById('sentence_len').value,
        num_iterations: +document.getElementById('num_iterations').value,
        samples_num: +document.getElementById('samples_num').value,
        alpha: +document.getElementById('alpha').value,
        beta: +document.getElementById('beta').value,
        gamma: +document.getElementById('gamma').value,
        image: r.result})})
    .then(function(resp){ return resp.json(); })
    .then(function(out){
      document.getElementById('final_out').value = out.final;
      document.getElementById('best_out').value = out.best;
      status.textContent = out.error ? ('error: ' + out.error) : 'done';
    })
    .catch(function(e){ status.textContent = 'error: ' + e; });
  };
  r.readAsDataURL(f);
});
updateVisibility();
</script></body></html>
"""


def render_page(cfg: ConzicConfig) -> str:
    return (
        _PAGE.replace("__ALPHA__", str(cfg.alpha))
        .replace("__BETA__", str(cfg.beta))
        .replace("__GAMMA__", str(cfg.gamma))
    )


def handle_submit(demo_fn, payload: dict) -> dict:
    """Decode the request, run the shared Submit callback, and wrap its
    (final, best) pair — the fallback analog of gradio's submit.click."""
    from PIL import Image

    data_url = payload["image"]
    b64 = data_url.split(",", 1)[1] if "," in data_url else data_url
    image = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    final, best = demo_fn(
        payload.get("run_type", "caption"),
        payload.get("control_type", "sentiment"),
        payload.get("sentiment_type", "positive"),
        payload.get("order", "shuffle"),
        payload.get("prompt", "Image of a"),
        payload.get("sentence_len", 10),
        payload.get("num_iterations", 1),
        payload.get("samples_num", 1),
        payload.get("alpha", 0.02),
        payload.get("beta", 2.0),
        payload.get("gamma", 5.0),
        image,
    )
    return {"final": final, "best": best}


def make_server(captioner, cfg: ConzicConfig, port: int,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    from conzic_torch.api.app import make_demo_fn

    demo_fn = make_demo_fn(captioner, cfg)
    page = render_page(cfg).encode("utf-8")
    # one generation at a time: the card is a serial resource and the
    # captioner's tables are shared
    submit_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path not in ("/", "/index.html"):
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(page)))
            self.end_headers()
            self.wfile.write(page)

        def do_POST(self):
            if self.path != "/submit":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n).decode("utf-8"))
                with submit_lock:
                    out = handle_submit(demo_fn, payload)
                body = json.dumps(out).encode("utf-8")
                code = 200
            except Exception as e:  # surfaced in the UI status line
                body = json.dumps(
                    {"final": "", "best": "", "error": str(e)}
                ).encode("utf-8")
                code = 500
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def serve(captioner, cfg: ConzicConfig, port: int = 7860) -> None:
    server = make_server(captioner, cfg, port)
    print(f"conzic-torch-app fallback UI serving on http://127.0.0.1:{port} "
          "(gradio not installed; same widgets, stdlib server)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
