"""Web chat UI: a self-contained HTML page over aiohttp (the reference's
gradio_web_server equivalent).

Counterpart of ``fastvlm_tpu/serve/web.py``. The page talks to the
controller: it lists the models, uploads an image with a preprocessing
mode, streams the answer, and records votes. Conversations and votes are
appended to a dated JSON log under ``log_dir``. ``aiohttp`` is imported by
``build_app`` and ``main`` only.
"""

from __future__ import annotations

import argparse
import base64
import datetime
import io
import json
import logging
import os
import sys
import time

from fastvlm_tpu_torch.data.constants import DEFAULT_IMAGE_TOKEN
from fastvlm_tpu_torch.data.conversation import conv_templates
from fastvlm_tpu_torch.data.preprocessing import expand2square
from fastvlm_tpu_torch.serve.protocol import ErrorCode, chunk
from fastvlm_tpu_torch.utils.logging import build_logger

logger = logging.getLogger("fastvlm_tpu_torch.web")

IMAGE_PROCESS_MODES = ("Crop", "Resize", "Pad", "Default")
VOTE_TYPES = ("upvote", "downvote", "flag")


def process_image_mode(b64: str, mode: str, max_len: int = 1344,
                       min_len: int = 672) -> str:
    """One message's image preprocessing (the reference's radio): "Pad"
    letterboxes to a square on the mean-pixel background, "Resize" forces
    336x336, "Crop" / "Default" pass through; every mode then shrinks an
    upload whose long edge exceeds ``max_len`` (aspect kept). Base64 image
    bytes in and out (the worker's wire format); an unknown mode raises
    ValueError."""
    from PIL import Image

    if mode not in IMAGE_PROCESS_MODES:
        raise ValueError(f"invalid image_process_mode: {mode}")
    img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    if mode == "Pad":
        img = expand2square(img, (122, 116, 104))
    elif mode == "Resize":
        img = img.resize((336, 336))
    if max(img.size) > max_len:
        aspect = max(img.size) / min(img.size)
        short = int(min(max_len / aspect, min_len, min(img.size)))
        w, h = img.size
        if h > w:
            w, h = short, int(short * aspect)
        else:
            w, h = int(short * aspect), short
        img = img.resize((w, h))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>FastVLM</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:860px;margin:2rem auto;padding:0 1rem}
 #log{border:1px solid #ccc;border-radius:8px;padding:1rem;min-height:260px;white-space:pre-wrap}
 .user{color:#0b5394}.assistant{color:#111}.meta{color:#888;font-size:.8em}
 textarea{width:100%;height:3.2em} button{padding:.4em 1.2em}
 img.preview{max-height:140px;border-radius:6px}
</style></head><body>
<h2>FastVLM chat</h2>
<div>model: <select id="model"></select>
 temperature <input id="temp" type="number" value="0.2" step="0.1" min="0" max="2" style="width:4em">
 max tokens <input id="maxtok" type="number" value="256" style="width:5em"></div>
<p><input type="file" id="image" accept="image/*">
 mode <select id="imgmode"><option>Default</option><option>Crop</option>
 <option>Resize</option><option>Pad</option></select>
 <img id="preview" class="preview"/></p>
<div id="log"></div>
<p><textarea id="prompt" placeholder="Ask about the image..."></textarea>
<button id="send">Send</button>
<button id="stop" title="cancel generation" disabled>Stop</button>
<button id="upvote" title="upvote">&#128077;</button>
<button id="downvote" title="downvote">&#128078;</button>
<button id="flag" title="flag">&#9872;</button>
<span id="stats" class="meta"></span></p>
<script>
async function refreshModels(){
  const r = await fetch('/api/models'); const j = await r.json();
  const sel = document.getElementById('model'); sel.innerHTML='';
  j.models.forEach(m=>{const o=document.createElement('option');o.textContent=m;sel.appendChild(o);});
}
refreshModels();
let imageB64 = null;
document.getElementById('image').onchange = e => {
  const f = e.target.files[0]; if(!f) return;
  const rd = new FileReader();
  rd.onload = () => { imageB64 = rd.result.split(',')[1];
    document.getElementById('preview').src = rd.result; };
  rd.readAsDataURL(f);
};
let inflight = null;  // AbortController of the active generation
document.getElementById('stop').onclick = () => {
  // aborting the fetch drops the SSE connection; the worker sees the
  // disconnect and aborts the row at the next chunk boundary (the
  // reference app's single-shot cancel, FastVLMModel.swift:141-151)
  if (inflight) inflight.abort();
};
document.getElementById('send').onclick = async () => {
  const log = document.getElementById('log');
  const prompt = document.getElementById('prompt').value;
  log.innerHTML += '<div class="user">USER: '+prompt+'</div>';
  const div = document.createElement('div'); div.className='assistant';
  div.textContent = 'ASSISTANT: '; log.appendChild(div);
  const body = {model: document.getElementById('model').value, prompt,
    images: imageB64 ? [imageB64] : [],
    image_process_mode: document.getElementById('imgmode').value,
    temperature: parseFloat(document.getElementById('temp').value),
    max_new_tokens: parseInt(document.getElementById('maxtok').value)};
  inflight = new AbortController();
  document.getElementById('stop').disabled = false;
  try {
    const resp = await fetch('/api/generate', {method:'POST',
      headers:{'Content-Type':'application/json'},
      body: JSON.stringify(body), signal: inflight.signal});
    const reader = resp.body.getReader(); const dec = new TextDecoder();
    let buf='';
    for(;;){
      const {done, value} = await reader.read(); if(done) break;
      buf += dec.decode(value, {stream:true});
      const parts = buf.split('\\u0000');
      buf = parts.pop();
      for(const p of parts){ if(!p) continue; const j = JSON.parse(p);
        div.textContent = 'ASSISTANT: ' + j.text;
        lastExchange = {prompt, response: j.text,
          model: document.getElementById('model').value};
        if(j.stats) document.getElementById('stats').textContent =
          'TTFT '+j.stats.ttft_ms+'ms · '+j.stats.tok_per_s+' tok/s';
      }
    }
  } catch (e) {
    if (e.name === 'AbortError') div.textContent += ' [stopped]';
    else throw e;
  } finally {
    inflight = null;
    document.getElementById('stop').disabled = true;
  }
};
let lastExchange = null;
for(const t of ['upvote','downvote','flag']){
  document.getElementById(t).onclick = async () => {
    if(!lastExchange) return;
    await fetch('/api/vote', {method:'POST',
      headers:{'Content-Type':'application/json'},
      body: JSON.stringify({type:t, ...lastExchange})});
    document.getElementById('stats').textContent = t + ' recorded';
  };
}
</script></body></html>"""


class WebServer:
    def __init__(self, controller_addr: str, log_dir: str = "."):
        self.controller_addr = controller_addr
        self.log_dir = log_dir

    def _log_file(self) -> str:
        d = datetime.datetime.now().strftime("%Y-%m-%d")
        return os.path.join(self.log_dir, f"{d}-conv.json")

    def log_conversation(self, record: dict) -> None:
        with open(self._log_file(), "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_vote(self, vote_type: str, record: dict) -> None:
        """An upvote / downvote / flag appended to the dated log with the
        exchange it rates."""
        entry = {"tstamp": round(time.time(), 4), "type": vote_type}
        entry.update(record)
        with open(self._log_file(), "a") as f:
            f.write(json.dumps(entry) + "\n")

    def build_app(self):
        import aiohttp
        from aiohttp import web

        routes = web.RouteTableDef()

        @routes.get("/")
        async def index(request):
            return web.Response(text=PAGE, content_type="text/html")

        @routes.get("/api/models")
        async def models(request):
            async with aiohttp.ClientSession() as s:
                await s.post(self.controller_addr + "/refresh_all_workers")
                async with s.post(self.controller_addr + "/list_models") as r:
                    return web.json_response(await r.json())

        @routes.post("/api/generate")
        async def generate(request):
            data = await request.json()
            conv = conv_templates["qwen_2"].copy()
            text = data.get("prompt", "")
            if data.get("images"):
                text = DEFAULT_IMAGE_TOKEN + "\n" + text
            conv.append_message(conv.roles[0], text)
            conv.append_message(conv.roles[1], None)
            mode = data.get("image_process_mode", "Default")
            try:
                images = [process_image_mode(b, mode)
                          for b in (data.get("images") or [])]
            except ValueError as e:
                return web.json_response({"error": str(e)}, status=400)
            payload = {
                "model": data.get("model", ""),
                "prompt": conv.get_prompt(),
                "images": images,
                "temperature": data.get("temperature", 0.2),
                "max_new_tokens": data.get("max_new_tokens", 256),
                "stop": conv.sep,
            }
            async with aiohttp.ClientSession() as s:
                async with s.post(self.controller_addr + "/get_worker_address",
                                  json={"model": payload["model"]}) as r:
                    addr = (await r.json())["address"]
                resp = web.StreamResponse()
                await resp.prepare(request)
                if not addr:
                    await resp.write(chunk("no available worker",
                                           ErrorCode.SERVER_ERROR))
                    return resp
                async with s.post(addr + "/worker_generate_stream",
                                  json=payload) as upstream:
                    async for piece, _ in upstream.content.iter_chunks():
                        await resp.write(piece)
                self.log_conversation({
                    "t": time.time(), "model": payload["model"],
                    "prompt": data.get("prompt", ""),
                    "had_image": bool(data.get("images"))})
                return resp

        @routes.post("/api/vote")
        async def vote(request):
            """{"type": "upvote" | "downvote" | "flag", "model", "prompt",
            "response"} -> the dated log; another type is a 400."""
            data = await request.json()
            vtype = data.get("type", "")
            if vtype not in VOTE_TYPES:
                return web.json_response({"error": "bad vote type"},
                                         status=400)
            self.log_vote(vtype, {
                "model": data.get("model", ""),
                "prompt": data.get("prompt", ""),
                "response": data.get("response", "")})
            return web.json_response({"ok": True})

        app = web.Application(client_max_size=64 * 1024 * 1024)
        app.add_routes(routes)
        return app


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--controller-address", default="http://localhost:10000")
    parser.add_argument("--log-dir", default=".")
    args = parser.parse_args(argv)
    build_logger(logger.name, "web_server.log")
    from aiohttp import web

    server = WebServer(args.controller_address, args.log_dir)
    web.run_app(server.build_app(), host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
