"""Interactive demo of the PyTorch/CUDA port: twin of ``instantir_tpu/cli/app.py``.

Loads the pipeline with both the previewer LoRA and (optionally) an LCM LoRA,
exposes ``instantir_restore`` with the "Creative Restoration" switch:
creative mode raises ``creative_start`` (-> ``control_guidance_end``) and can
switch the UNet to the LCM adapter; per-step previews come back as a gallery
when asked.

Two UIs over the same ``InstantIRApp`` core: ``gradio`` when installed,
otherwise a dependency-free stdlib-HTTP page (``make_demo_http_server``) with
the same controls: upload, prompt, Creative Restoration checkbox,
steps/CFG/guidance sliders and the per-step preview gallery.

Usage (on the card):
  python -m instantir_tpu_torch.cli.app --sdxl_path /path/sdxl \\
      --instantir_path /path/instantir --vision_encoder_path /path/dinov2 \\
      [--lcm_lora_path lcm_lora.bin] --port 7860
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from instantir_tpu_torch.cli.infer import DEFAULT_NEG_PROMPT, DEFAULT_PROMPT, resize_img


def _is_lora(name: str) -> bool:
    return ".lora_A." in name or ".lora_B." in name


def extract_unet_lora(unet) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of every UNet LoRA parameter, copied (an
    'adapter' snapshot that later swaps do not touch)."""
    return {name: p.detach().clone() for name, p in unet.named_parameters() if _is_lora(name)}


def load_lcm_lora_variant(unet, lcm_lora_path: str) -> Dict[str, torch.Tensor]:
    """The 'lcm' adapter variant: every UNet LoRA tensor zeroed, then a
    diffusers-format LCM-LoRA file (``.safetensors`` / ``.bin``) merged in by
    name (``convert.import_previewer_lora``), each in its parameter's dtype
    and on its device."""
    from instantir_tpu_torch.convert import import_previewer_lora, load_torch_state_dict

    params = {name: p for name, p in unet.named_parameters() if _is_lora(name)}
    variant = {name: torch.zeros_like(p) for name, p in params.items()}
    tensors, _, unmatched = import_previewer_lora(load_torch_state_dict(lcm_lora_path), params, ())
    if not tensors:
        raise ValueError(f"no LoRA tensors from {lcm_lora_path} merged into the UNet")
    if unmatched:
        print(f"[app] WARNING: {len(unmatched)} LCM-LoRA tensors unmatched (first: {unmatched[:3]})")
    for name, value in tensors.items():
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(params[name].shape):
            raise ValueError(f"{lcm_lora_path}: {name} has shape {tuple(value.shape)}, the UNet's "
                             f"{tuple(params[name].shape)}")
        variant[name] = value.to(dtype=params[name].dtype, device=params[name].device)
    return variant


class InstantIRApp:
    def __init__(self, pipe, encode_fn, lora_variants: Optional[dict] = None):
        """pipe: InstantIRPipeline; encode_fn: list[str] -> (embeds, pooled);
        lora_variants: {name: {parameter name: tensor}} of UNet LoRA tensors,
        the named adapters ("previewer"/"lcm"). The previewer's own LoRA
        tensors are snapshotted as the "previewer" variant."""
        self.pipe = pipe
        self.encode = encode_fn
        self.lora_variants = dict(lora_variants or {})
        self.lora_variants.setdefault("previewer", extract_unet_lora(pipe.unet))
        self.active_adapter = "previewer"

    def set_adapter(self, name: str):
        """Swap the UNet's LoRA tensors to the named variant, in place
        (``copy_``): a recorded restore graph reads the weights where they
        lie, so a ``fused`` restore follows the swap."""
        if name == self.active_adapter:
            return
        if name not in self.lora_variants:
            raise KeyError(f"unknown adapter {name!r}; have {sorted(self.lora_variants)}")
        if self.pipe._frozen is not None:
            raise ValueError("set_adapter on a frozen previewer: freeze_previewer freed the UNet's LoRA pairs")
        variant = self.lora_variants[name]
        params = {n: p for n, p in self.pipe.unet.named_parameters() if _is_lora(n)}
        if set(variant) != set(params):
            raise ValueError(f"adapter {name!r} names other LoRA tensors than the UNet's "
                             f"({sorted(set(variant) ^ set(params))[:3]})")
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(variant[n])
        self.active_adapter = name

    def instantir_restore(
        self,
        lq_image,
        prompt: str = "",
        steps: int = 30,
        cfg_scale: float = 7.0,
        guidance_end: float = 1.0,
        creative_restoration: bool = False,
        seed: int = 3407,
        height: int = 1024,
        width: int = 1024,
        preview_start: float = 0.0,
        save_preview_row: bool = False,
        fused: Optional[bool] = None,
        min_side: int = 768,
        max_side: int = 1024,
        base_pixel_number: int = 64,
    ):
        """Restore a Pillow image; returns (restored Pillow image at the
        requested size, the previewer row as Pillow images). ``fused``
        (default: on a CUDA pipeline) replays the restore as a CUDA graph,
        recorded once per setting."""
        from PIL import Image

        from instantir_tpu_torch.pipeline.instantir import RestoreConfig

        if creative_restoration:
            # creative mode: switch to the LCM adapter when one is loaded, and
            # stop ControlNet guidance earlier so the text prompt drives the late steps
            if "lcm" in self.lora_variants:
                self.set_adapter("lcm")
            guidance_end = min(guidance_end, 0.75)
        else:
            self.set_adapter("previewer")
        lq_resized, out_size = resize_img(
            lq_image, width=width if width else None, height=height if height else None,
            min_side=min_side, max_side=max_side, base_pixel_number=base_pixel_number,
        )
        lq = torch.from_numpy(np.asarray(lq_resized, np.float32)[None] / 127.5 - 1.0)
        prompt = prompt if prompt else DEFAULT_PROMPT
        pe, pooled = self.encode([prompt])
        npe, npooled = self.encode([DEFAULT_NEG_PROMPT])
        dtype = next(self.pipe.unet.parameters()).dtype
        pe, pooled, npe, npooled = (torch.as_tensor(x).to(device=self.pipe.device, dtype=dtype)
                                    for x in (pe, pooled, npe, npooled))
        cfg = RestoreConfig(
            num_inference_steps=int(steps),
            guidance_scale=float(cfg_scale),
            preview_start=float(preview_start),
            control_guidance_end=float(guidance_end),
            save_preview_row=bool(save_preview_row),
            fused=self.pipe.device.type == "cuda" if fused is None else bool(fused),
        )
        image, previews = self.pipe.restore(
            lq, pe, pooled, negative_prompt_embeds=npe, negative_pooled_embeds=npooled, cfg=cfg,
            generator=torch.Generator(device=self.pipe.device).manual_seed(int(seed)),
        )

        def to_pil(x):
            return Image.fromarray(((np.clip(np.asarray(x), -1, 1) + 1) * 127.5).astype(np.uint8))

        out = to_pil(image[0]).resize(out_size, Image.BILINEAR)
        gallery = [to_pil(p[0]) for p in previews] if previews else []
        return out, gallery


# ---------------------------------------------------------------------------
# stdlib-HTTP demo UI (no gradio required)
# ---------------------------------------------------------------------------

_DEMO_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>InstantIR</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;max-width:72rem}
 .cols{display:flex;gap:2rem;flex-wrap:wrap}
 .col{flex:1;min-width:20rem}
 label{display:block;margin:.6rem 0 .15rem;font-size:.9rem;color:#333}
 input[type=text],input[type=number]{width:100%;box-sizing:border-box;padding:.3rem}
 input[type=range]{width:100%}
 #out{max-width:100%;border:1px solid #ccc;min-height:8rem}
 #gallery img{height:7rem;margin:.2rem;border:1px solid #ddd}
 button{margin-top:1rem;padding:.5rem 1.5rem;font-size:1rem}
 #status{color:#666;margin-left:1rem}
 .val{color:#888;font-size:.8rem}
</style></head><body>
<h1>InstantIR: Blind Image Restoration</h1>
<div class="cols"><div class="col">
 <label>Low-quality image</label><input type="file" id="file" accept="image/*">
 <label>Prompt (creative restoration)</label><input type="text" id="prompt">
 <label><input type="checkbox" id="creative"> Creative Restoration</label>
 <label>Steps <span class="val" id="steps_v">30</span></label>
 <input type="range" id="steps" min="1" max="50" value="30"
        oninput="steps_v.textContent=this.value">
 <label>CFG scale <span class="val" id="cfg_v">7.0</span></label>
 <input type="range" id="cfg" min="1" max="10" step="0.1" value="7.0"
        oninput="cfg_v.textContent=this.value">
 <label>Guidance end <span class="val" id="gend_v">1.0</span></label>
 <input type="range" id="gend" min="0" max="1" step="0.05" value="1.0"
        oninput="gend_v.textContent=this.value">
 <label>Preview start <span class="val" id="pstart_v">0.0</span></label>
 <input type="range" id="pstart" min="0" max="1" step="0.05" value="0.0"
        oninput="pstart_v.textContent=this.value">
 <label>Seed</label><input type="number" id="seed" value="3407">
 <label><input type="checkbox" id="previews"> Show per-step previews</label>
 <button id="run">Restore</button><span id="status"></span>
</div><div class="col">
 <label>Restored</label><img id="out">
 <label>Previewer row</label><div id="gallery"></div>
</div></div>
<script>
run.onclick = async () => {
  if (!file.files.length) { status.textContent = "pick an image first"; return; }
  status.textContent = "restoring..."; run.disabled = true;
  const q = new URLSearchParams({
    prompt: prompt.value, steps: steps.value, cfg_scale: cfg.value,
    guidance_end: gend.value, preview_start: pstart.value, seed: seed.value,
    creative: creative.checked ? "1" : "0", previews: previews.checked ? "1" : "0",
  });
  try {
    const resp = await fetch("/api/restore?" + q, {method: "POST", body: file.files[0]});
    const data = await resp.json();
    if (!resp.ok) throw new Error(data.error || resp.statusText);
    out.src = "data:image/png;base64," + data.image;
    gallery.innerHTML = "";
    for (const p of data.previews || []) {
      const im = document.createElement("img");
      im.src = "data:image/png;base64," + p;
      gallery.appendChild(im);
    }
    status.textContent = "done (adapter: " + data.adapter + ")";
  } catch (e) { status.textContent = "error: " + e.message; }
  run.disabled = false;
};
</script></body></html>
"""


def make_demo_http_server(app: "InstantIRApp", host: str = "127.0.0.1", port: int = 7860):
    """Single-user demo over stdlib HTTP: ``GET /`` serves the page,
    ``POST /api/restore?...`` takes raw image bytes and returns JSON with
    the base64-PNG restored image and preview gallery. Requests are
    serialized (``InstantIRApp`` swaps the adapter in place)."""
    import base64
    import io
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    from PIL import Image

    lock = threading.Lock()

    def _png_b64(pil_img) -> str:
        buf = io.BytesIO()
        pil_img.save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path in ("/", "/index.html"):
                self._reply(200, _DEMO_HTML.encode(), "text/html; charset=utf-8")
            else:
                self.send_error(404)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/api/restore":
                self.send_error(404)
                return
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            data = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                lq = Image.open(io.BytesIO(data)).convert("RGB")
                with lock:
                    out, gallery = app.instantir_restore(
                        lq,
                        prompt=q.get("prompt", ""),
                        steps=int(q.get("steps", 30)),
                        cfg_scale=float(q.get("cfg_scale", 7.0)),
                        guidance_end=float(q.get("guidance_end", 1.0)),
                        creative_restoration=q.get("creative", "0") == "1",
                        seed=int(q.get("seed", 3407)),
                        height=int(q.get("height", 1024)),
                        width=int(q.get("width", 1024)),
                        preview_start=float(q.get("preview_start", 0.0)),
                        save_preview_row=q.get("previews", "0") == "1",
                        min_side=int(q.get("min_side", 768)),
                        max_side=int(q.get("max_side", 1024)),
                        base_pixel_number=int(q.get("base_pixel_number", 64)),
                    )
                    adapter = app.active_adapter
                body = json.dumps({
                    "image": _png_b64(out),
                    "previews": [_png_b64(g) for g in gallery],
                    "adapter": adapter,
                }).encode()
                self._reply(200, body, "application/json")
            except Exception as e:  # noqa: BLE001 -- the page shows the error, the server lives on
                self._reply(500, json.dumps({"error": str(e)}).encode(), "application/json")

    return ThreadingHTTPServer((host, port), Handler)


def launch(argv: Optional[List[str]] = None, device="cuda"):
    try:
        import gradio as gr
    except ImportError:
        gr = None  # fall back to the stdlib-HTTP demo page below

    from instantir_tpu_torch.cli.infer import encode_prompts
    from instantir_tpu_torch.parallel import initialize_distributed
    from instantir_tpu_torch.pipeline.load import load_instantir_pipeline, load_text_encoders

    initialize_distributed(device=device)  # a no-op without torchrun
    p = argparse.ArgumentParser(description="InstantIR demo (PyTorch/CUDA port)")
    p.add_argument("--sdxl_path", required=True)
    p.add_argument("--instantir_path", required=True)
    p.add_argument("--vision_encoder_path", required=True)
    p.add_argument("--lcm_lora_path", default=None, help="LCM-LoRA for creative mode")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    args = p.parse_args(argv)

    pipe = load_instantir_pipeline(args.sdxl_path, args.instantir_path, args.vision_encoder_path, device=device)
    variants = None
    if args.lcm_lora_path:
        variants = {"lcm": load_lcm_lora_variant(pipe.unet, args.lcm_lora_path)}
    encoders = load_text_encoders(args.sdxl_path, device=device)

    def encode(prompts):
        return encode_prompts(encoders, prompts, pipe.device)

    app = InstantIRApp(pipe, encode, lora_variants=variants)

    if gr is None:
        httpd = make_demo_http_server(app, args.host, args.port)
        print(f"[app] gradio not installed — stdlib demo UI on http://{args.host}:{args.port}/")
        httpd.serve_forever()
        return

    with gr.Blocks() as demo:
        gr.Markdown("# InstantIR: Blind Image Restoration")
        with gr.Row():
            with gr.Column():
                lq = gr.Image(type="pil", label="Low-quality image")
                prompt = gr.Textbox(label="Prompt (creative restoration)")
                creative = gr.Checkbox(label="Creative Restoration")
                steps = gr.Slider(1, 50, value=30, step=1, label="Steps")
                cfg = gr.Slider(1.0, 10.0, value=7.0, label="CFG scale")
                guidance_end = gr.Slider(0.0, 1.0, value=1.0, label="Guidance end")
                preview_start = gr.Slider(0.0, 1.0, value=0.0, label="Preview start")
                seed = gr.Number(value=3407, label="Seed")
                previews = gr.Checkbox(label="Show per-step previews")
                run = gr.Button("Restore")
            with gr.Column():
                out = gr.Image(label="Restored")
                gallery = gr.Gallery(label="Previewer row")

        def _run(lq_im, prompt_s, steps_v, cfg_v, guidance_end_v, creative_v, seed_v, previews_v, preview_start_v):
            return app.instantir_restore(
                lq_im, prompt=prompt_s, steps=steps_v, cfg_scale=cfg_v, guidance_end=guidance_end_v,
                creative_restoration=creative_v, seed=seed_v,
                preview_start=preview_start_v, save_preview_row=previews_v,
            )

        run.click(
            _run,
            [lq, prompt, steps, cfg, guidance_end, creative, seed, previews, preview_start],
            [out, gallery],
        )
    demo.launch()


if __name__ == "__main__":
    launch()
