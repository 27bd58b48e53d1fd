"""Interactive preview server, the GIMP-plugin dialog analog (the port of
`mathmap_tpu/preview.py`).

A localhost HTTP app (stdlib only): a browser page with a source editor,
the expression-database tree, parameter widgets generated from the filter
signature (a freehand curve editor among them), a live-rerendering
preview, input-image upload, an animation renderer with a frame scrubber
(render_animation's t-sweep), a param sweep (render_batch over the one
uploaded image) and the node-graph composer. The pages are the
reference's. Renders run on the state's device: the GPU, or the CPU with
`--cpu` (or MMTPU_PLATFORM=cpu); the uploaded image is staged there once,
at the first render after an upload. A multi-frame GIF upload becomes an
animated input; decoding a GIF needs Pillow, as everywhere in the package.

    python -m mathmap_tpu_torch.preview [--port 8731] [--input img.png] [--cpu]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = r"""<!DOCTYPE html>
<html><head><title>mathmap_tpu_torch preview</title><style>
body { font-family: sans-serif; display: flex; gap: 16px; margin: 16px;
       background: #1e1e24; color: #ddd; }
textarea { width: 100%; height: 240px; font-family: monospace;
           background: #15151a; color: #cde; border: 1px solid #444; }
#left { width: 44%; } #right { flex: 1; }
#preview { max-width: 100%; border: 1px solid #444; image-rendering: pixelated; }
#error { color: #f66; white-space: pre-wrap; font-family: monospace; }
#params label { display: block; margin: 6px 0; }
#library { max-height: 200px; overflow-y: auto; font-size: 13px;
           border: 1px solid #333; padding: 6px; }
#library a { color: #8cf; cursor: pointer; display: block; }
input[type=range] { width: 240px; vertical-align: middle; }
select, button { background: #2a2a33; color: #ddd; border: 1px solid #555; }
</style></head><body>
<div id="left">
  <h3>mathmap_tpu_torch <small style="color:#888">(MathMap on PyTorch and CUDA)</small></h3>
  <textarea id="src"></textarea><br>
  <button onclick="render()">Render (Ctrl-Enter)</button>
  t: <input type="range" id="t" min="0" max="1" step="0.01" value="0"
            oninput="document.getElementById('tv').textContent=this.value; render()">
  <span id="tv">0</span>
  <div style="margin:6px 0">
    <button onclick="animate()">Animate</button>
    frames: <input id="nframes" value="24" size="3">
    <button onclick="sweep()">Sweep</button>
    <input id="sweepspec" placeholder="param=lo:hi" size="11"
           title="animate a slider: e.g. angle=0:6 over the frame count">
    <button id="playbtn" onclick="togglePlay()" style="display:none">&#9654;</button>
    <input type="range" id="scrub" min="0" max="23" value="0" style="display:none"
           oninput="showFrame(parseInt(this.value))">
    <span id="framelabel"></span>
  </div>
  <div style="margin:6px 0">
    input image: <input type="file" id="upload" accept="image/*"
                        onchange="uploadImage(this)">
    <span id="inputinfo"></span>
  </div>
  <div id="params"></div>
  <h4>Filter library</h4><div id="library"></div>
  <div id="error"></div>
</div>
<div id="right">
  <div id="pwrap" style="position:relative; display:inline-block">
    <img id="preview" width="512" draggable="false">
    <div id="selbox" style="position:absolute; border:1px dashed #fc6;
         pointer-events:none; display:none"></div>
  </div>
  <div id="stats" style="color:#888"></div>
  <div style="color:#888; font-size:12px">drag on the preview to select a
    region (GIMP-selection render: only the selection is evaluated and
    composited in place) <button id="clearsel" style="display:none"
    onclick="clearSelection()">clear selection</button></div>
</div>
<script>
let paramState = {};
let renderSeq = 0;
let selRegion = null;  // [x, y, w, h] in image pixels, or null
async function render() {
  const src = document.getElementById('src').value;
  const t = parseFloat(document.getElementById('t').value);
  const req = {source: src, t: t, params: paramState};
  if (selRegion) req.region = selRegion;
  const body = JSON.stringify(req);
  const t0 = performance.now();
  const seq = ++renderSeq;
  const res = await fetch('/render', {method: 'POST', body: body});
  const data = await res.json();
  if (seq !== renderSeq) return;  // a newer render superseded this one
  const err = document.getElementById('error');
  if (data.error) { err.textContent = data.error; return; }
  err.textContent = '';
  document.getElementById('preview').src = 'data:image/png;base64,' + data.png;
  document.getElementById('stats').textContent =
    data.width + 'x' + data.height + '  ' + (performance.now()-t0).toFixed(0) + ' ms round-trip';
  renderParams(data.params);
}
let paramSig = '';
function renderParams(params) {
  const div = document.getElementById('params');
  // rebuild only when the param SET changes: wiping the DOM mid-slider-
  // drag destroys the input under the pointer and kills the drag
  const sig = params.map(p => p.name + ':' + p.kind).join(',');
  if (sig === paramSig && div.childElementCount) return;
  paramSig = sig;
  div.innerHTML = '';
  for (const p of params) {
    if (p.kind === 'float' || p.kind === 'int') {
      const v = paramState[p.name] !== undefined ? paramState[p.name] : p.value;
      div.insertAdjacentHTML('beforeend',
        `<label>${p.name}: <input type="range" min="${p.lo}" max="${p.hi}"
         step="${p.kind==='int'?1:(p.hi-p.lo)/200}" value="${v}"
         oninput="paramState['${p.name}']=parseFloat(this.value); render()">
         <span>${v}</span></label>`);
    } else if (p.kind === 'color') {
      const v = paramState[p.name] !== undefined ? paramState[p.name] : (Array.isArray(p.value) ? p.value : [0,0,0,1]);
      const hex = '#' + v.slice(0,3).map(c => Math.round(c*255).toString(16).padStart(2,'0')).join('');
      div.insertAdjacentHTML('beforeend',
        `<label>${p.name}: <input type="color" value="${hex}"
         oninput="paramState['${p.name}']=[parseInt(this.value.substr(1,2),16)/255,
                  parseInt(this.value.substr(3,2),16)/255,
                  parseInt(this.value.substr(5,2),16)/255, 1]; render()"></label>`);
    } else if (p.kind === 'curve') {
      div.insertAdjacentHTML('beforeend',
        `<label>${p.name} (curve — drag points, click to add, dblclick to remove):
           <select onchange="setCurvePreset('${p.name}', this.value)">
             <option value="">preset...</option>
             <option value="identity">identity</option>
             <option value="invert">invert</option>
             <option value="gamma22">gamma 2.2</option>
             <option value="gamma045">gamma 0.45</option>
             <option value="contrast">contrast S</option>
           </select><br>
           <canvas id="curve_${p.name}" width="256" height="128"
                   style="border:1px solid #555;background:#15151a"></canvas></label>`);
      initCurveEditor(p.name);
    } else if (p.kind === 'gradient') {
      div.insertAdjacentHTML('beforeend',
        `<label>${p.name} (gradient — multi-stop):
           <div id="gstops_${p.name}"></div>
           <button onclick="addStop('${p.name}')">+ stop</button>
           <canvas id="gprev_${p.name}" width="256" height="14"
                   style="border:1px solid #555;vertical-align:middle"></canvas>
         </label>`);
      initGradient(p.name);
    } else if (p.kind === 'bool') {
      const v = paramState[p.name] !== undefined ? paramState[p.name] : p.value;
      div.insertAdjacentHTML('beforeend',
        `<label>${p.name}: <input type="checkbox" ${v?'checked':''}
         onchange="paramState['${p.name}']=this.checked?1:0; render()"></label>`);
    }
  }
}
const CURVES = {
  identity: t => t,
  invert: t => 1 - t,
  gamma22: t => Math.pow(t, 1/2.2),
  gamma045: t => Math.pow(t, 2.2),
  contrast: t => t*t*(3-2*t),
};
// ---- freehand curve editor: draggable control points -> 64-entry LUT ----
let curvePoints = {};   // name -> [[x,y], ...] sorted by x, in [0,1]^2
let curveDrag = null;
function curveLUT(pts) {
  return Array.from({length: 64}, (_, i) => {
    const x = i / 63;
    let j = 0;
    while (j < pts.length - 1 && pts[j + 1][0] < x) j++;
    const [x0, y0] = pts[j], [x1, y1] = pts[Math.min(j + 1, pts.length - 1)];
    const f = x1 > x0 ? (x - x0) / (x1 - x0) : 0;
    return Math.min(1, Math.max(0, y0 + (y1 - y0) * Math.min(1, Math.max(0, f))));
  });
}
function drawCurve(name) {
  const cv = document.getElementById('curve_' + name);
  if (!cv) return;
  const ctx = cv.getContext('2d');
  const pts = curvePoints[name];
  ctx.clearRect(0, 0, cv.width, cv.height);
  ctx.strokeStyle = '#333';
  for (let g = 1; g < 4; g++) {
    ctx.beginPath(); ctx.moveTo(cv.width * g / 4, 0); ctx.lineTo(cv.width * g / 4, cv.height); ctx.stroke();
    ctx.beginPath(); ctx.moveTo(0, cv.height * g / 4); ctx.lineTo(cv.width, cv.height * g / 4); ctx.stroke();
  }
  const lut = curveLUT(pts);
  ctx.strokeStyle = '#8cf';
  ctx.beginPath();
  lut.forEach((v, i) => {
    const px = i / 63 * cv.width, py = (1 - v) * cv.height;
    i ? ctx.lineTo(px, py) : ctx.moveTo(px, py);
  });
  ctx.stroke();
  ctx.fillStyle = '#fc6';
  for (const [x, y] of pts)
    ctx.fillRect(x * cv.width - 3, (1 - y) * cv.height - 3, 6, 6);
}
function initCurveEditor(name) {
  if (!curvePoints[name]) curvePoints[name] = [[0, 0], [1, 1]];
  const cv = document.getElementById('curve_' + name);
  const pos = e => {
    const r = cv.getBoundingClientRect();
    return [Math.min(1, Math.max(0, (e.clientX - r.left) / r.width)),
            Math.min(1, Math.max(0, 1 - (e.clientY - r.top) / r.height))];
  };
  const hit = p => curvePoints[name].findIndex(
    q => Math.abs(q[0] - p[0]) < 0.05 && Math.abs(q[1] - p[1]) < 0.1);
  cv.onmousedown = e => {
    const p = pos(e);
    let i = hit(p);
    if (i < 0) {  // click empty space: add a point
      curvePoints[name].push(p);
      curvePoints[name].sort((a, b) => a[0] - b[0]);
      i = hit(p);
    }
    curveDrag = {name, i};
    drawCurve(name);
  };
  cv.onmousemove = e => {
    if (!curveDrag || curveDrag.name !== name) return;
    const pts = curvePoints[name];
    const p = pos(e);
    const i = curveDrag.i;
    const lo = i > 0 ? pts[i - 1][0] + 0.01 : 0;
    const hi = i < pts.length - 1 ? pts[i + 1][0] - 0.01 : 1;
    pts[i] = [Math.min(hi, Math.max(lo, p[0])), p[1]];
    if (i === 0) pts[i][0] = 0;
    if (i === pts.length - 1) pts[i][0] = 1;
    drawCurve(name);
  };
  const endDrag = () => {
    if (!curveDrag) return;
    paramState[name] = curveLUT(curvePoints[name]);
    curveDrag = null;
    render();
  };
  cv.onmouseup = endDrag;
  window.addEventListener('mouseup', endDrag);
  cv.ondblclick = e => {
    const pts = curvePoints[name];
    const i = hit(pos(e));
    if (i > 0 && i < pts.length - 1) {  // endpoints stay
      pts.splice(i, 1);
      paramState[name] = curveLUT(pts);
      drawCurve(name);
      render();
    }
  };
  drawCurve(name);
}
function setCurvePreset(name, kind) {
  if (!kind) return;
  const fn = CURVES[kind];
  curvePoints[name] = Array.from({length: 9}, (_, i) => [i / 8, fn(i / 8)]);
  paramState[name] = curveLUT(curvePoints[name]);
  drawCurve(name);
  render();
}
// ---- input image upload ----
async function uploadImage(input) {
  const file = input.files[0];
  if (!file) return;
  const buf = await file.arrayBuffer();
  const b64 = btoa(new Uint8Array(buf).reduce((s, b) => s + String.fromCharCode(b), ''));
  const res = await fetch('/upload', {method: 'POST',
                                      body: JSON.stringify({data: b64})});
  const info = await res.json();
  document.getElementById('inputinfo').textContent =
    info.error ? info.error : `${info.width}x${info.height}`;
  // the canvas geometry changed: drop stale selection bounds, then
  // ALWAYS re-render the new drawable (clearSelection alone early-
  // returns when no selection exists — review r5: uploads stopped
  // refreshing the preview in the common no-selection case)
  selRegion = null; selDrag = null; drawSelBox();
  render();
}
// ---- region (GIMP selection): drag on the preview to select ----
let selDrag = null;  // [x0, y0] image px while dragging
function imgPos(e) {
  const img = document.getElementById('preview');
  const r = img.getBoundingClientRect();
  const sx = img.naturalWidth / r.width, sy = img.naturalHeight / r.height;
  return [Math.max(0, Math.min(img.naturalWidth - 1, Math.round((e.clientX - r.left) * sx))),
          Math.max(0, Math.min(img.naturalHeight - 1, Math.round((e.clientY - r.top) * sy)))];
}
function drawSelBox() {
  const img = document.getElementById('preview');
  const box = document.getElementById('selbox');
  const btn = document.getElementById('clearsel');
  if (!selRegion) { box.style.display = 'none'; btn.style.display = 'none'; return; }
  const sx = img.clientWidth / img.naturalWidth, sy = img.clientHeight / img.naturalHeight;
  box.style.left = (selRegion[0] * sx) + 'px';
  box.style.top = (selRegion[1] * sy) + 'px';
  box.style.width = (selRegion[2] * sx) + 'px';
  box.style.height = (selRegion[3] * sy) + 'px';
  box.style.display = 'block'; btn.style.display = 'inline';
}
function clearSelection() {
  if (!selRegion && !selDrag) return;
  selRegion = null; selDrag = null; drawSelBox(); render();
}
document.getElementById('preview').addEventListener('mousedown', e => {
  if (frames.length) return;  // scrubbing an animation: no selection
  selDrag = imgPos(e); e.preventDefault();
});
window.addEventListener('mousemove', e => {
  if (!selDrag) return;
  const p = imgPos(e);
  selRegion = [Math.min(selDrag[0], p[0]), Math.min(selDrag[1], p[1]),
               Math.abs(p[0] - selDrag[0]) + 1, Math.abs(p[1] - selDrag[1]) + 1];
  drawSelBox();
});
window.addEventListener('mouseup', e => {
  if (!selDrag) return;
  selDrag = null;
  if (!selRegion || selRegion[2] < 4 || selRegion[3] < 4) {  // a click
    selRegion = null; drawSelBox(); render(); return;
  }
  render();
});
window.addEventListener('keydown', e => {
  if (e.key === 'Escape') clearSelection();
});
// ---- animation: one-program t-sweep on the server, scrub client-side ----
let frames = [];
let playTimer = null;
function showFrame(i) {
  if (!frames.length) return;
  document.getElementById('preview').src = 'data:image/png;base64,' + frames[i];
  document.getElementById('framelabel').textContent = `${i + 1}/${frames.length}`;
  document.getElementById('scrub').value = i;
}
function togglePlay() {
  const btn = document.getElementById('playbtn');
  if (playTimer) { clearInterval(playTimer); playTimer = null; btn.innerHTML = '&#9654;'; return; }
  let i = parseInt(document.getElementById('scrub').value);
  playTimer = setInterval(() => { i = (i + 1) % frames.length; showFrame(i); }, 83);
  btn.innerHTML = '&#9646;&#9646;';
}
async function animate() {
  const n = Math.min(120, Math.max(2, parseInt(document.getElementById('nframes').value) || 24));
  const body = JSON.stringify({source: document.getElementById('src').value,
                               params: paramState, frames: n});
  document.getElementById('stats').textContent = 'rendering ' + n + ' frames...';
  const t0 = performance.now();
  const res = await fetch('/animate', {method: 'POST', body: body});
  const data = await res.json();
  if (data.error) { document.getElementById('error').textContent = data.error; return; }
  frames = data.frames;
  const scrub = document.getElementById('scrub');
  scrub.max = frames.length - 1;
  scrub.style.display = 'inline-block';
  document.getElementById('playbtn').style.display = 'inline-block';
  document.getElementById('stats').textContent =
    n + ' frames in ' + (performance.now() - t0).toFixed(0) + ' ms';
  showFrame(0);
}
async function sweep() {
  const spec = document.getElementById('sweepspec').value;
  const m = spec.match(/^\s*(\w+)\s*=\s*(-?[\d.]+)\s*:\s*(-?[\d.]+)\s*$/);
  if (!m) { document.getElementById('error').textContent = 'sweep expects param=lo:hi (e.g. angle=0:6)'; return; }
  const n = Math.min(120, Math.max(2, parseInt(document.getElementById('nframes').value) || 24));
  const body = JSON.stringify({source: document.getElementById('src').value,
                               params: paramState, param: m[1],
                               lo: parseFloat(m[2]), hi: parseFloat(m[3]), frames: n,
                               t: parseFloat(document.getElementById('t').value)});
  document.getElementById('stats').textContent = 'sweeping ' + m[1] + ' over ' + n + ' steps...';
  const t0 = performance.now();
  const res = await fetch('/sweep', {method: 'POST', body: body});
  const data = await res.json();
  if (data.error) { document.getElementById('error').textContent = data.error; return; }
  document.getElementById('error').textContent = '';
  frames = data.frames;
  const scrub = document.getElementById('scrub');
  scrub.max = frames.length - 1;
  scrub.style.display = 'inline-block';
  document.getElementById('playbtn').style.display = 'inline-block';
  document.getElementById('stats').textContent =
    n + ' sweep frames in ' + (performance.now() - t0).toFixed(0) + ' ms';
  showFrame(0);
}
function hex2rgb(h) {
  return [parseInt(h.substr(1,2),16)/255, parseInt(h.substr(3,2),16)/255,
          parseInt(h.substr(5,2),16)/255];
}
// ---- multi-stop gradient editor ----
let gradStops = {};   // name -> [[pos, '#rrggbb'], ...]
function initGradient(name) {
  if (!gradStops[name]) gradStops[name] = [[0, '#000000'], [1, '#ffffff']];
  drawStops(name);
}
function addStop(name) {
  gradStops[name].push([0.5, '#808080']);
  gradStops[name].sort((a, b) => a[0] - b[0]);
  drawStops(name);
  setGradient(name);
}
function rmStop(name, i) {
  if (gradStops[name].length <= 2) return;
  gradStops[name].splice(i, 1);
  drawStops(name);
  setGradient(name);
}
function updStop(name, i, pos, col) {
  const s = gradStops[name][i];
  if (pos !== null) s[0] = parseFloat(pos);
  if (col !== null) s[1] = col;
  gradStops[name].sort((a, b) => a[0] - b[0]);
  drawStops(name);
  setGradient(name);
}
function drawStops(name) {
  const div = document.getElementById('gstops_' + name);
  if (!div) return;
  div.innerHTML = gradStops[name].map(([pos, col], i) =>
    `<div style="font-size:12px">
       <input type="range" min="0" max="1" step="0.01" value="${pos}"
              style="width:120px" onchange="updStop('${name}',${i},this.value,null)">
       <input type="color" value="${col}"
              oninput="updStop('${name}',${i},null,this.value)">
       <a style="cursor:pointer;color:#f66" onclick="rmStop('${name}',${i})">x</a>
     </div>`).join('');
  const cv = document.getElementById('gprev_' + name);
  if (cv) {
    const ctx = cv.getContext('2d');
    const g = ctx.createLinearGradient(0, 0, cv.width, 0);
    for (const [pos, col] of gradStops[name]) g.addColorStop(pos, col);
    ctx.fillStyle = g;
    ctx.fillRect(0, 0, cv.width, cv.height);
  }
}
function setGradient(name) {
  const stops = gradStops[name].map(([p, c]) => [p, hex2rgb(c)]);
  paramState[name] = Array.from({length: 64}, (_, i) => {
    const t = i / 63;
    let j = 0;
    while (j < stops.length - 1 && stops[j + 1][0] < t) j++;
    const [p0, c0] = stops[j], [p1, c1] = stops[Math.min(j + 1, stops.length - 1)];
    const f = p1 > p0 ? Math.min(1, Math.max(0, (t - p0) / (p1 - p0))) : 0;
    return [c0[0] + (c1[0] - c0[0]) * f, c0[1] + (c1[1] - c0[1]) * f,
            c0[2] + (c1[2] - c0[2]) * f, 1];
  });
  render();
}
async function loadLibrary() {
  const res = await fetch('/library');
  const lib = await res.json();
  const div = document.getElementById('library');
  for (const cat in lib) {
    div.insertAdjacentHTML('beforeend', `<b>${cat}</b>`);
    for (const name of lib[cat]) {
      div.insertAdjacentHTML('beforeend',
        `<a onclick="loadFilter('${name}')">&nbsp;&nbsp;${name}</a>`);
    }
  }
}
async function loadFilter(name) {
  const res = await fetch('/filter/' + name);
  document.getElementById('src').value = await res.text();
  paramState = {};
  render();
}
document.getElementById('src').addEventListener('keydown', (e) => {
  if (e.key === 'Enter' && e.ctrlKey) render();
});
loadLibrary();
document.getElementById('src').value =
  'filter twirl (image in, float angle: -10-10 (3))\n' +
  '  in(toXY(ra:[r, a + angle * (1 - r / R) ^ 2]))\nend';
render();
</script></body></html>
"""

_COMPOSER_PAGE = r"""<!DOCTYPE html>
<html><head><title>mathmap_tpu_torch composer</title><style>
body { font-family: sans-serif; margin: 0; background: #1e1e24; color: #ddd;
       display: flex; height: 100vh; }
#side { width: 320px; padding: 12px; overflow-y: auto; }
#canvas { flex: 1; background: #15151a; position: relative; }
svg { width: 100%; height: 100%; }
.node rect { fill: #2a2a33; stroke: #556; rx: 6; }
.node.out rect { stroke: #fc6; stroke-width: 2; }
.node text { fill: #cde; font-size: 12px; pointer-events: none; }
.port { fill: #8cf; cursor: crosshair; }
.port.in { fill: #6d6; }
.edge { stroke: #8cf; stroke-width: 2; fill: none; }
select, button, input { background: #2a2a33; color: #ddd; border: 1px solid #555; }
#preview { max-width: 300px; border: 1px solid #444; }
pre { background: #15151a; color: #9ab; font-size: 11px; white-space: pre-wrap;
      max-height: 200px; overflow-y: auto; }
#error { color: #f66; white-space: pre-wrap; font-family: monospace; }
.pbox { position: absolute; background: #20202a; border: 1px solid #555;
        padding: 4px; font-size: 11px; }
.pbox input { width: 60px; }
</style></head><body>
<div id="side">
  <h3>Composer <small style="color:#888"><a href="/" style="color:#888">editor</a></small></h3>
  <select id="palette"></select>
  <button onclick="addNode()">Add node</button><br><br>
  <button onclick="renderGraph()">Render</button>
  <button onclick="saveMmc()">Save .mmc</button>
  <button onclick="document.getElementById('mmcfile').click()">Load .mmc</button>
  <input type="file" id="mmcfile" accept=".mmc" style="display:none"
         onchange="loadMmc(this.files[0])">
  <div style="color:#888;font-size:12px;margin:6px 0">
    drag nodes &middot; drag from an <b style="color:#8cf">output</b> port to a
    green <b style="color:#6d6">image input</b> port to connect &middot;
    click a node header to make it the output (orange) &middot;
    double-click a header to delete
  </div>
  <img id="preview"><div id="stats" style="color:#888"></div>
  <h4>Generated source</h4><pre id="source"></pre>
  <div id="error"></div>
</div>
<div id="canvas"><svg id="svg">
  <g id="edges"></g><g id="nodes"></g>
  <path id="pending" class="edge" style="display:none"></path>
</svg></div>
<script>
let palette = {};
let nodes = {};          // id -> {filter, x, y, params:{}, imgrefs:{pname: {ref|input}}}
let output = null;
let nid = 0;
let drag = null;         // {id, dx, dy} node drag
let wire = null;         // {from} pending connection

async function loadPalette() {
  palette = await (await fetch('/palette')).json();
  const sel = document.getElementById('palette');
  for (const name of Object.keys(palette).sort())
    sel.insertAdjacentHTML('beforeend', `<option>${name}</option>`);
}
function addNode(name, x, y) {
  name = name || document.getElementById('palette').value;
  const id = 'n' + (++nid);
  nodes[id] = {filter: name, x: x || 60 + 30 * (nid % 8), y: y || 40 + 40 * (nid % 6),
               params: {}, imgrefs: {}};
  const imgs = palette[name].params.filter(p => p.kind === 'image');
  if (imgs.length) nodes[id].imgrefs[imgs[0].name] = {input: 0};
  output = id;
  draw();
  return id;
}
function del(id) {
  delete nodes[id];
  for (const n of Object.values(nodes))
    for (const [k, v] of Object.entries(n.imgrefs))
      if (v.ref === id) n.imgrefs[k] = {input: 0};
  if (output === id) output = Object.keys(nodes).pop() || null;
  draw();
}
function portPos(id, pname) {   // input-port coords
  const n = nodes[id];
  const imgs = palette[n.filter].params.filter(p => p.kind === 'image');
  const i = imgs.findIndex(p => p.name === pname);
  return [n.x, n.y + 26 + i * 16];
}
function outPos(id) {
  const n = nodes[id];
  return [n.x + 140, n.y + 26];
}
function draw() {
  const g = document.getElementById('nodes');
  const eg = document.getElementById('edges');
  g.innerHTML = ''; eg.innerHTML = '';
  for (const [id, n] of Object.entries(nodes)) {
    const imgs = palette[n.filter].params.filter(p => p.kind === 'image');
    const nums = palette[n.filter].params.filter(p => p.kind === 'float' || p.kind === 'int');
    const h = 36 + Math.max(imgs.length, 1) * 16 + nums.length * 18;
    let inner = `<rect width="140" height="${h}"></rect>
      <rect class="hdr" width="140" height="18" fill="#334" data-id="${id}"></rect>
      <text x="6" y="13">${id}: ${n.filter}</text>
      <circle class="port out" data-id="${id}" cx="140" cy="26" r="5"></circle>`;
    imgs.forEach((p, i) => {
      inner += `<circle class="port in" data-id="${id}" data-p="${p.name}"
                  cx="0" cy="${26 + i * 16}" r="5"></circle>
                <text x="8" y="${30 + i * 16}">${p.name}</text>`;
    });
    nums.forEach((p, i) => {
      const v = n.params[p.name] !== undefined ? n.params[p.name] : p.default;
      inner += `<text x="6" y="${30 + Math.max(imgs.length,1) * 16 + i * 18 + 12}"
                 >${p.name} = ${Number(v).toFixed(2)}</text>
                <rect class="pedit" data-id="${id}" data-p="${p.name}" x="100"
                  y="${30 + Math.max(imgs.length,1) * 16 + i * 18}" width="36" height="14"
                  fill="#445" style="cursor:pointer"></rect>
                <text x="104" y="${30 + Math.max(imgs.length,1) * 16 + i * 18 + 11}"
                  style="font-size:10px">edit</text>`;
    });
    g.insertAdjacentHTML('beforeend',
      `<g class="node${id === output ? ' out' : ''}" transform="translate(${n.x},${n.y})">${inner}</g>`);
    for (const [pname, v] of Object.entries(n.imgrefs)) {
      if (v.ref && nodes[v.ref]) {
        const [x1, y1] = outPos(v.ref), [x2, y2] = portPos(id, pname);
        eg.insertAdjacentHTML('beforeend',
          `<path class="edge" d="M${x1},${y1} C${x1 + 50},${y1} ${x2 - 50},${y2} ${x2},${y2}"></path>`);
      }
    }
  }
}
const svg = document.getElementById('svg');
function evPos(e) {
  const r = svg.getBoundingClientRect();
  return [e.clientX - r.left, e.clientY - r.top];
}
svg.addEventListener('mousedown', e => {
  const t = e.target;
  if (t.classList.contains('hdr')) {
    const id = t.dataset.id;
    const [mx, my] = evPos(e);
    drag = {id, dx: mx - nodes[id].x, dy: my - nodes[id].y, moved: false};
  } else if (t.classList.contains('out')) {
    wire = {from: t.dataset.id};
  } else if (t.classList.contains('pedit')) {
    const id = t.dataset.id, p = t.dataset.p;
    const meta = palette[nodes[id].filter].params.find(q => q.name === p);
    const cur = nodes[id].params[p] !== undefined ? nodes[id].params[p] : meta.default;
    const v = prompt(`${id}.${p} (${meta.lo}..${meta.hi})`, cur);
    if (v !== null) { nodes[id].params[p] = parseFloat(v); draw(); }
  }
});
svg.addEventListener('mousemove', e => {
  const [mx, my] = evPos(e);
  if (drag) {
    nodes[drag.id].x = mx - drag.dx; nodes[drag.id].y = my - drag.dy;
    drag.moved = true;
    draw();
  } else if (wire) {
    const [x1, y1] = outPos(wire.from);
    const p = document.getElementById('pending');
    p.style.display = 'block';
    p.setAttribute('d', `M${x1},${y1} C${x1 + 50},${y1} ${mx - 50},${my} ${mx},${my}`);
  }
});
svg.addEventListener('mouseup', e => {
  const t = e.target;
  if (wire && t.classList.contains('in')) {
    nodes[t.dataset.id].imgrefs[t.dataset.p] = {ref: wire.from};
    draw();
  } else if (drag && !drag.moved) {
    output = drag.id;   // click header: set as output
    draw();
  }
  wire = null; drag = null;
  document.getElementById('pending').style.display = 'none';
});
svg.addEventListener('dblclick', e => {
  if (e.target.classList.contains('hdr')) del(e.target.dataset.id);
});
function graphJson() {
  return {
    nodes: Object.entries(nodes).map(([id, n]) => ({
      id, filter: n.filter,
      params: Object.assign({}, n.params,
        Object.fromEntries(Object.entries(n.imgrefs).map(([k, v]) => [k, v]))),
    })),
    output,
  };
}
async function renderGraph() {
  const res = await fetch('/compose', {method: 'POST',
    body: JSON.stringify(Object.assign(graphJson(), {t: 0}))});
  const data = await res.json();
  const err = document.getElementById('error');
  if (data.error) { err.textContent = data.error; return; }
  err.textContent = '';
  document.getElementById('preview').src = 'data:image/png;base64,' + data.png;
  document.getElementById('source').textContent = data.source;
}
async function saveMmc() {
  const res = await fetch('/compose_mmc', {method: 'POST',
    body: JSON.stringify(graphJson())});
  const data = await res.json();
  if (data.error) { document.getElementById('error').textContent = data.error; return; }
  const a = document.createElement('a');
  a.href = 'data:text/plain;base64,' + btoa(data.mmc);
  a.download = 'composition.mmc';
  a.click();
}
async function loadMmc(file) {
  if (!file) return;
  const text = await file.text();
  const res = await fetch('/parse_mmc', {method: 'POST',
    body: JSON.stringify({mmc: text})});
  const data = await res.json();
  const err = document.getElementById('error');
  if (data.error) { err.textContent = data.error; return; }
  err.textContent = '';
  nodes = {}; nid = 0;
  for (const n of data.nodes) {
    const entry = {filter: n.filter, x: n.x, y: n.y, params: {}, imgrefs: {}};
    for (const [k, v] of Object.entries(n.params)) {
      if (v && typeof v === 'object') entry.imgrefs[k] = v;
      else entry.params[k] = v;
    }
    nodes[n.id] = entry;
    const m = /^n([0-9]+)$/.exec(n.id);
    if (m) nid = Math.max(nid, parseInt(m[1]));
  }
  output = data.output;
  draw();
  renderGraph();
}
loadPalette().then(() => {
  const a = addNode('grayscale'), b = addNode('twirl');
  nodes[b].imgrefs['in'] = {ref: a};
  nodes[a].x = 60; nodes[a].y = 60; nodes[b].x = 280; nodes[b].y = 120;
  output = b;
  draw();
  renderGraph();
});
</script></body></html>
"""


def _host(out) -> np.ndarray:
    return out.cpu().numpy()


class PreviewState:
    """The preview's one drawable, its filter cache and its device; one
    render at a time (`lock`)."""

    def __init__(self, input_image, size: int, db, device=None):
        from .api import platform_device, resolve_device

        self.device = platform_device() if device is None else resolve_device(device)
        self.input_image = input_image  # host array, or None
        self._staged = None  # input_image on the device
        self.size = size
        self.db = db
        self.lock = threading.Lock()
        self._filter_cache = {}

    def _compile(self, source: str):
        from .api import compile_source

        filt = self._filter_cache.get(source)
        if filt is None:
            filt = compile_source(source)
            filt.filters.update({k: v for k, v in self.db.library_defs().items()
                                 if k not in filt.filters})
            if len(self._filter_cache) >= 8:
                # a long editing session must not grow the cache without bound
                self._filter_cache.pop(next(iter(self._filter_cache)))
            self._filter_cache[source] = filt
        return filt

    def set_input(self, png_bytes: bytes):
        """Replace the input image from uploaded file bytes (PNG, PAM or
        PPM; other formats need Pillow). Multi-frame
        files (animated GIFs) become ANIMATED (T, H, W, 4) inputs: the
        preview's frame and origValXY(x, y, frame) index them. It is
        staged on the device at the next render."""
        from .imgio.images import read_animation

        stack = read_animation(io.BytesIO(png_bytes), as_uint8=True)
        new_input = stack if stack.shape[0] > 1 else stack[0]
        with self.lock:
            self.input_image = new_input
            self._staged = None
        return new_input.shape[-2], new_input.shape[-3]

    def _inputs(self, filt) -> list:
        """The drawable on the device, once per upload, bound to every image
        param of `filt` (a two-input filter applied to one layer). Call
        under self.lock."""
        from .convert import inputs_from_numpy

        if not filt.image_params or self.input_image is None:
            return []
        if self._staged is None:
            self._staged = inputs_from_numpy([self.input_image], self.device)[0]
        return [self._staged] * len(filt.image_params)

    def _size(self, inputs):
        if inputs:
            return inputs[0].shape[-2], inputs[0].shape[-3]
        return self.size, self.size

    def animate(self, source: str, params: dict, num_frames: int):
        """The t-sweep (render_animation) -> list of (H, W, 4) arrays."""
        with self.lock:
            filt = self._compile(source)
            inputs = self._inputs(filt)
            w, h = self._size(inputs)
            out = filt.render_animation(*inputs, num_frames=num_frames, width=w, height=h,
                                        params=params, device=self.device)
            return list(_host(out))

    def sweep(self, source: str, name: str, lo: float, hi: float,
              num_frames: int, t: float, params: dict):
        """Slider animation: N param steps over the ONE uploaded drawable
        in one render_batch call (the GUI twin of the CLI --param-sweep)."""
        import math

        from .api import shared

        with self.lock:
            filt = self._compile(source)
            kinds = {p.name: p.kind for p in filt.params}
            if name not in kinds:
                raise ValueError(
                    f"sweep param {name!r}: filter has no such param "
                    f"(has: {', '.join(sorted(kinds)) or 'none'})")
            if kinds[name] not in ("float", "int"):
                raise ValueError(f"sweep param {name!r} is {kinds[name]!r};"
                                 " only float/int params sweep")
            vals = [lo + (hi - lo) * i / (num_frames - 1) for i in range(num_frames)]
            if kinds[name] == "int":
                vals = [int(math.floor(v + 0.5)) for v in vals]
            inputs = self._inputs(filt)
            w, h = self._size(inputs)
            out = filt.render_batch(
                *[shared(a) for a in inputs], ts=np.full(num_frames, t, np.float32),
                frames=np.arange(num_frames, dtype=np.float32), width=w, height=h,
                params=[{**params, name: v} for v in vals], device=self.device)
            return list(_host(out))

    def build_graph(self, req: dict):
        """Node-editor JSON -> DesignerGraph (the composer canvas: nodes and
        edges in the browser, compiled to one source here)."""
        from .designer.graph import DesignerGraph, InputRef, Node, Ref

        graph = DesignerGraph(db=self.db)
        for n in req.get("nodes", []):
            params = {}
            for k, v in n.get("params", {}).items():
                if isinstance(v, dict) and "ref" in v:
                    params[k] = Ref(str(v["ref"]))
                elif isinstance(v, dict) and "input" in v:
                    params[k] = InputRef(int(v["input"]))
                else:
                    params[k] = float(v)
            graph.nodes[str(n["id"])] = Node(str(n["id"]), str(n["filter"]), params)
        graph.output = str(req.get("output") or "")
        return graph

    def compose(self, req: dict):
        """Compile the node graph to source and render it."""
        source = self.build_graph(req).to_source()
        out, _meta = self.render(source, float(req.get("t", 0.0)), {})
        return source, out

    def parse_mmc(self, text: str) -> dict:
        """.mmc composer file -> node-editor JSON (the inverse of
        build_graph), laid out by dependency depth."""
        from .designer.graph import InputRef, Ref, from_mmc

        graph = from_mmc(text, db=self.db)
        order = graph._topo()  # validates refs and cycles; gives the depth
        order += [nid for nid in graph.nodes if nid not in set(order)]
        depth = {}
        for nid in order:
            d = 0
            for v in graph.nodes[nid].params.values():
                if isinstance(v, Ref) and v.node_id in depth:
                    d = max(d, depth[v.node_id] + 1)
            depth[nid] = d
        nodes = []
        lane = {}
        for nid in order:
            node = graph.nodes[nid]
            d = depth[nid]
            lane[d] = lane.get(d, -1) + 1
            params = {}
            for k, v in node.params.items():
                if isinstance(v, Ref):
                    params[k] = {"ref": v.node_id}
                elif isinstance(v, InputRef):
                    params[k] = {"input": v.index}
                else:
                    params[k] = v
            nodes.append({"id": node.node_id, "filter": node.filter_name,
                          "params": params,
                          "x": 60 + 220 * d, "y": 40 + 110 * lane[d]})
        return {"nodes": nodes, "output": graph.output}

    def palette(self):
        meta = {}
        for name, entry in self.db.entries.items():
            meta[name] = {"params": [
                {"name": p.name, "kind": p.kind,
                 "lo": p.lo if p.lo is not None else 0.0,
                 "hi": p.hi if p.hi is not None else 1.0,
                 "default": (p.default if isinstance(p.default, (int, float))
                             else 0.0)}
                for p in entry.fdef.params]}
        return meta

    def render(self, source: str, t: float, params: dict, region=None):
        """One frame -> (host (H, W, 4) array, param widget metadata).
        region=(x, y, w, h): the filter is applied to the selection only
        (world coordinates stay the full canvas's, as in the API and the
        CLI) and composited IN PLACE over the drawable, so the preview
        shows the full canvas with only the selection changed."""
        from .runtime.options import RenderOptions

        with self.lock:
            filt = self._compile(source)
            inputs = self._inputs(filt)
            w, h = self._size(inputs)
            if region is not None:
                rx, ry, rw, rh = (int(v) for v in region)
                crop = filt.render(*inputs, width=w, height=h, t=t, params=params,
                                   options=RenderOptions(region=(rx, ry, rw, rh)),
                                   device=self.device)
                # background: the drawable's current frame in the render's
                # float range (animated stacks show frame 0: the preview
                # scrubs t, not frame)
                bg = self.input_image
                if bg is not None and bg.ndim == 4:
                    bg = bg[0]
                if bg is not None:
                    bg = (bg.astype(np.float32) / 255.0
                          if bg.dtype == np.uint8 else bg.astype(np.float32))
                if bg is None or bg.shape[:2] != (h, w):
                    # a generative canvas apart from the drawable: onto black
                    bg = np.zeros((h, w, 4), np.float32)
                    bg[..., 3] = 1.0
                out = bg.copy()
                out[ry:ry + rh, rx:rx + rw] = _host(crop)
            else:
                out = _host(filt.render(*inputs, width=w, height=h, t=t, params=params,
                                        device=self.device))
            meta = [
                {
                    "name": p.name, "kind": p.kind,
                    "lo": p.lo if p.lo is not None else 0.0,
                    "hi": p.hi if p.hi is not None else 1.0,
                    "value": params.get(
                        p.name, p.default if p.default is not None else 0.0
                    ),
                }
                for p in filt.params
                if p.kind in ("float", "int", "bool", "color", "curve", "gradient")
            ]
            return out, meta


def _make_handler(state: PreviewState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            data = body if isinstance(body, bytes) else body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/":
                self._send(200, _PAGE, "text/html")
            elif self.path == "/composer":
                self._send(200, _COMPOSER_PAGE, "text/html")
            elif self.path == "/palette":
                self._send(200, json.dumps(state.palette()))
            elif self.path == "/library":
                lib = {cat: sorted(names) for cat, names in sorted(state.db.categories.items())}
                self._send(200, json.dumps(lib))
            elif self.path.startswith("/filter/"):
                name = self.path[len("/filter/"):]
                if name in state.db.entries:
                    self._send(200, state.db.entries[name].source, "text/plain")
                else:
                    self._send(404, "no such filter", "text/plain")
            else:
                self._send(404, "not found", "text/plain")

        def _png_b64(self, arr):
            from .imgio.images import to_uint8
            from .imgio.png import encode_png

            # the fast Sub-filter encoder: a slider drag re-encodes every frame
            return base64.b64encode(encode_png(to_uint8(arr), level=1)).decode()

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                if self.path == "/render":
                    out, meta = state.render(req["source"], float(req.get("t", 0.0)),
                                             req.get("params", {}), region=req.get("region"))
                    self._send(200, json.dumps({
                        "png": self._png_b64(out),
                        "width": out.shape[1], "height": out.shape[0],
                        "params": meta,
                    }))
                elif self.path == "/upload":
                    w, h = state.set_input(base64.b64decode(req["data"]))
                    self._send(200, json.dumps({"width": w, "height": h}))
                elif self.path == "/compose":
                    source, out = state.compose(req)
                    self._send(200, json.dumps({"source": source, "png": self._png_b64(out)}))
                elif self.path == "/compose_mmc":
                    graph = state.build_graph(req)
                    graph._topo()  # validate (cycles, unknown refs)
                    self._send(200, json.dumps({"mmc": graph.to_mmc()}))
                elif self.path == "/parse_mmc":
                    self._send(200, json.dumps(state.parse_mmc(req["mmc"])))
                elif self.path == "/animate":
                    n = max(2, min(120, int(req.get("frames", 24))))
                    frames = state.animate(req["source"], req.get("params", {}), n)
                    self._send(200, json.dumps({"frames": [self._png_b64(f) for f in frames]}))
                elif self.path == "/sweep":
                    n = max(2, min(120, int(req.get("frames", 24))))
                    frames = state.sweep(
                        req["source"], str(req["param"]), float(req["lo"]), float(req["hi"]),
                        n, float(req.get("t", 0.0)), req.get("params", {}))
                    self._send(200, json.dumps({"frames": [self._png_b64(f) for f in frames]}))
                else:
                    self._send(404, "not found", "text/plain")
            except Exception as exc:  # noqa: BLE001 — the page shows every error
                if hasattr(exc, "format"):
                    msg = exc.format()  # MMError: source span + caret
                elif isinstance(exc, (ValueError, KeyError)):
                    msg = str(exc)  # validation: one readable line
                else:
                    msg = traceback.format_exc()
                self._send(200, json.dumps({"error": str(msg)}))

    return Handler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="mathmap_tpu_torch interactive preview")
    ap.add_argument("--port", type=int, default=8731)
    ap.add_argument("--input", default=None, help="input image for image filters")
    ap.add_argument("--size", type=int, default=256, help="preview size for generative filters")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    args = ap.parse_args(argv)

    from .api import platform_device
    from .expression_db import default_db
    from .imgio.images import read_image

    try:
        device = "cpu" if args.cpu else platform_device()
    except (ValueError, RuntimeError) as exc:
        raise SystemExit(str(exc))
    if args.input:
        img = read_image(args.input)
    else:
        # the default checker-gradient test card
        h = w = args.size
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack(
            [xx / w, yy / h, ((xx // 16 + yy // 16) % 2).astype(np.float32),
             np.ones((h, w))], axis=-1,
        ).astype(np.float32)

    state = PreviewState(img, args.size, default_db(), device=device)
    server = ThreadingHTTPServer(("127.0.0.1", args.port), _make_handler(state))
    print(f"mathmap_tpu_torch preview on http://127.0.0.1:{args.port}/ ({state.device})")
    print(f"node-graph composer on http://127.0.0.1:{args.port}/composer")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
