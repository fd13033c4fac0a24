"""Self-contained interactive HTML report.

Port of `tpu_deer/viz/html_report.py` (numpy only), computed by the port's
metrics.

Capability parity with the reference's plotly InteractiveVisualizer
(visualization.py:786-1016: 3-D emotion-space scatter + interactive
dashboard) without the plotly dependency: one HTML file with the data
embedded as JSON and vanilla-JS canvas/SVG rendering —

  * KPI stat-tile row (CCC / MAE / ECE / uncertainty-error r)
  * drag-rotatable 3-D VAD emotion space, predictions colored by a
    sequential uncertainty ramp, nearest-point hover tooltip
  * training curves (loss and validation CCC as separate single-axis
    panels — never a dual axis) with crosshair + tooltip
  * uncertainty vs |error| scatter with nearest-point tooltip
  * reliability diagram (observed vs ideal) with legend
  * per-dimension CCC bars, one hue (magnitude job), value-on-cap labels

Light and dark modes are both defined (CSS custom properties, OS setting +
`data-theme` toggle); every label uses text tokens, never series color.
Works from file:// with zero network access.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _subsample(n: int, cap: int, seed: int = 0) -> np.ndarray:
    if n <= cap:
        return np.arange(n)
    return np.sort(np.random.default_rng(seed).choice(n, size=cap, replace=False))


def create_interactive_report(
    predictions: np.ndarray,
    targets: np.ndarray,
    uncertainties: np.ndarray,
    history: dict | None = None,
    output_path: str = "interactive_report.html",
    max_points: int = 1500,
    title: str = "Multimodal DEER — interactive report",
) -> str:
    """Render predictions/targets/uncertainties (+ training history) into a
    single self-contained HTML file. Returns the output path."""
    from tpu_deer_torch.core.metrics import ccc_np, ece_np, pearson_np

    predictions = np.asarray(predictions, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    uncertainties = np.asarray(uncertainties, dtype=np.float64)
    history = history or {}

    dims = ["valence", "arousal", "dominance"][: predictions.shape[1]]
    ccc = {d: ccc_np(targets[:, i], predictions[:, i]) for i, d in enumerate(dims)}
    mae = float(np.abs(predictions - targets).mean())
    ece = ece_np(predictions, targets, uncertainties)
    err = np.abs(predictions - targets).mean(axis=1)
    unc = uncertainties.mean(axis=1)
    r = pearson_np(err, unc)

    # Reliability diagram data (uncertainty-quantile bins).
    order = np.argsort(unc)
    n_bins = 10
    bins = np.array_split(order, n_bins)
    rel = [
        {
            "confidence": float(1.0 - unc[b].mean()),
            "accuracy": float(1.0 - err[b].mean()),
            "count": int(len(b)),
        }
        for b in bins
        if len(b)
    ]

    idx = _subsample(len(predictions), max_points)
    payload = {
        "title": title,
        "dims": dims,
        "kpi": {
            "ccc_avg": float(np.mean(list(ccc.values()))),
            "mae_avg": mae,
            "ece": float(ece),
            "unc_err_r": float(r),
            "n_samples": int(len(predictions)),
        },
        "ccc_per_dim": {d: float(v) for d, v in ccc.items()},
        "points": {
            "pred": predictions[idx].round(4).tolist(),
            "target": targets[idx].round(4).tolist(),
            "uncertainty": unc[idx].round(4).tolist(),
            "error": err[idx].round(4).tolist(),
        },
        "history": {
            k: [None if (v is None or not np.isfinite(v)) else float(v)
                for v in vals]
            for k, vals in history.items()
            if isinstance(vals, (list, tuple)) and len(vals)
        },
        "reliability": rel,
    }

    html = _HTML_TEMPLATE.replace("__DATA__", json.dumps(payload))
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        f.write(html)
    return output_path


# The template keeps everything inline: palette custom properties (light and
# dark selected separately), canvas renderers, tooltip layer. Series hues are
# the validated reference palette (slots 1-3 + the sequential blue ramp).
_HTML_TEMPLATE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>Multimodal DEER — interactive report</title>
<style>
.viz-root {
  color-scheme: light;
  --surface-1:#fcfcfb; --page:#f9f9f7;
  --text-primary:#0b0b0b; --text-secondary:#52514e; --text-muted:#898781;
  --grid:#e1e0d9; --axis:#c3c2b7; --border:rgba(11,11,11,0.10);
  --series-1:#2a78d6; --series-2:#eb6834; --series-3:#1baf7a;
  --seq-100:#cde2fb; --seq-250:#86b6ef; --seq-400:#3987e5;
  --seq-550:#1c5cab; --seq-700:#0d366b;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1:#1a1a19; --page:#0d0d0d;
    --text-primary:#ffffff; --text-secondary:#c3c2b7; --text-muted:#898781;
    --grid:#2c2c2a; --axis:#383835; --border:rgba(255,255,255,0.10);
    --series-1:#3987e5; --series-2:#d95926; --series-3:#199e70;
    --seq-100:#104281; --seq-250:#1c5cab; --seq-400:#2a78d6;
    --seq-550:#6da7ec; --seq-700:#cde2fb;
  }
}
:root[data-theme="dark"] .viz-root {
  color-scheme: dark;
  --surface-1:#1a1a19; --page:#0d0d0d;
  --text-primary:#ffffff; --text-secondary:#c3c2b7; --text-muted:#898781;
  --grid:#2c2c2a; --axis:#383835; --border:rgba(255,255,255,0.10);
  --series-1:#3987e5; --series-2:#d95926; --series-3:#199e70;
  --seq-100:#104281; --seq-250:#1c5cab; --seq-400:#2a78d6;
  --seq-550:#6da7ec; --seq-700:#cde2fb;
}
body { margin:0; background:var(--page); font-family:system-ui,-apple-system,"Segoe UI",sans-serif; }
.viz-root { color:var(--text-primary); max-width:1160px; margin:0 auto; padding:24px 20px 48px; background:var(--page); }
h1 { font-size:22px; font-weight:600; margin:0 0 4px; }
.subtitle { color:var(--text-secondary); font-size:13px; margin-bottom:20px; }
.kpis { display:grid; grid-template-columns:repeat(auto-fit,minmax(160px,1fr)); gap:12px; margin-bottom:20px; }
.tile { background:var(--surface-1); border:1px solid var(--border); border-radius:10px; padding:14px 16px; }
.tile .label { font-size:12px; color:var(--text-secondary); margin-bottom:6px; }
.tile .value { font-size:28px; font-weight:600; }
.grid2 { display:grid; grid-template-columns:1fr 1fr; gap:16px; }
@media (max-width: 860px){ .grid2 { grid-template-columns:1fr; } }
.card { background:var(--surface-1); border:1px solid var(--border); border-radius:10px; padding:14px 16px 10px; margin-bottom:16px; position:relative; }
.card h2 { font-size:14px; font-weight:600; margin:0 0 2px; }
.card .hint { font-size:12px; color:var(--text-muted); margin-bottom:8px; }
canvas { width:100%; display:block; touch-action:none; }
.legend { display:flex; gap:16px; font-size:12px; color:var(--text-secondary); margin:6px 2px 2px; flex-wrap:wrap; }
.legend .key { display:inline-block; width:14px; height:0; border-top:2px solid; margin-right:5px; vertical-align:middle; border-radius:1px; }
.legend .swatch { display:inline-block; width:10px; height:10px; border-radius:2px; margin-right:5px; vertical-align:-1px; }
.tooltip { position:fixed; pointer-events:none; background:var(--surface-1); border:1px solid var(--border); border-radius:8px; box-shadow:0 4px 14px rgba(0,0,0,0.12); padding:8px 10px; font-size:12px; color:var(--text-secondary); display:none; z-index:10; min-width:120px; }
.tooltip .v { color:var(--text-primary); font-weight:600; }
.tooltip .row { display:flex; justify-content:space-between; gap:12px; margin-top:2px; }
.ramp { display:flex; align-items:center; gap:8px; font-size:12px; color:var(--text-muted); margin-top:6px; }
.ramp .bar { flex:0 0 120px; height:8px; border-radius:4px;
  background:linear-gradient(90deg,var(--seq-100),var(--seq-400),var(--seq-700)); }
table.data { width:100%; border-collapse:collapse; font-size:12px; color:var(--text-secondary); }
table.data th, table.data td { text-align:right; padding:4px 8px; border-bottom:1px solid var(--grid); font-variant-numeric:tabular-nums; }
table.data th { color:var(--text-muted); font-weight:500; }
table.data td:first-child, table.data th:first-child { text-align:left; }
details summary { font-size:12px; color:var(--text-muted); cursor:pointer; margin-top:6px; }
.toggle { position:absolute; top:14px; right:16px; font-size:12px; color:var(--text-secondary); background:none; border:1px solid var(--border); border-radius:6px; padding:3px 8px; cursor:pointer; }
</style>
</head>
<body>
<div class="viz-root" id="root">
  <h1 id="title"></h1>
  <div class="subtitle" id="subtitle"></div>
  <div class="kpis" id="kpis"></div>
  <div class="card" id="space-card">
    <button class="toggle" id="theme-toggle" type="button">dark</button>
    <h2>Emotion space (VAD)</h2>
    <div class="hint">drag to rotate · hover a point for values · color = predictive uncertainty</div>
    <canvas id="space" height="420"></canvas>
    <div class="ramp"><span>low</span><div class="bar"></div><span>high uncertainty</span></div>
  </div>
  <div class="grid2">
    <div class="card"><h2>Training loss</h2><div class="hint">per epoch</div><canvas id="loss" height="220"></canvas></div>
    <div class="card"><h2>Validation CCC</h2><div class="hint">per validation epoch</div><canvas id="ccc" height="220"></canvas></div>
  </div>
  <div class="grid2">
    <div class="card"><h2>Uncertainty vs |error|</h2><div class="hint">per sample · hover for values</div><canvas id="scatter" height="260"></canvas></div>
    <div class="card"><h2>Reliability diagram</h2><div class="hint">uncertainty-quantile bins</div><canvas id="reliability" height="260"></canvas>
      <div class="legend"><span><span class="key" style="border-color:var(--series-1)"></span>observed</span><span><span class="key" style="border-color:var(--text-muted)"></span>ideal</span></div>
    </div>
  </div>
  <div class="card"><h2>CCC per dimension</h2><div class="hint">concordance correlation coefficient</div><canvas id="bars" height="200"></canvas>
    <details><summary>table view</summary><table class="data" id="table"></table></details>
  </div>
</div>
<div class="tooltip" id="tip"></div>
<script id="report-data" type="application/json">__DATA__</script>
<script>
"use strict";
const DATA = JSON.parse(document.getElementById("report-data").textContent);
const root = document.getElementById("root");
const tip = document.getElementById("tip");
const css = name => getComputedStyle(root).getPropertyValue(name).trim();
document.getElementById("title").textContent = DATA.title;
document.getElementById("subtitle").textContent =
  DATA.kpi.n_samples + " samples · " + DATA.dims.join(" / ");

const toggle = document.getElementById("theme-toggle");
toggle.addEventListener("click", () => {
  const cur = document.documentElement.getAttribute("data-theme") === "dark";
  document.documentElement.setAttribute("data-theme", cur ? "light" : "dark");
  toggle.textContent = cur ? "dark" : "light";
  renderAll();
});

function tile(label, value) {
  const t = document.createElement("div"); t.className = "tile";
  const l = document.createElement("div"); l.className = "label"; l.textContent = label;
  const v = document.createElement("div"); v.className = "value"; v.textContent = value;
  t.append(l, v); return t;
}
const k = DATA.kpi;
const kpis = document.getElementById("kpis");
kpis.append(
  tile("CCC average", k.ccc_avg.toFixed(3)),
  tile("MAE average", k.mae_avg.toFixed(3)),
  tile("ECE", k.ece.toFixed(3)),
  tile("uncertainty–error r", k.unc_err_r.toFixed(3)),
);

function setupCanvas(id) {
  const c = document.getElementById(id);
  const dpr = window.devicePixelRatio || 1;
  const w = c.clientWidth, h = parseInt(c.getAttribute("height"), 10);
  c.width = w * dpr; c.height = h * dpr; c.style.height = h + "px";
  const ctx = c.getContext("2d");
  ctx.setTransform(dpr, 0, 0, dpr, 0, 0);
  ctx.clearRect(0, 0, w, h);
  return { c, ctx, w, h };
}
function showTip(ev, rowsHtmlSafe) {
  tip.replaceChildren(...rowsHtmlSafe);
  tip.style.display = "block";
  const pad = 14;
  let x = ev.clientX + pad, y = ev.clientY + pad;
  const r = tip.getBoundingClientRect();
  if (x + r.width > window.innerWidth - 8) x = ev.clientX - r.width - pad;
  if (y + r.height > window.innerHeight - 8) y = ev.clientY - r.height - pad;
  tip.style.left = x + "px"; tip.style.top = y + "px";
}
function tipRow(label, value, strong) {
  const d = document.createElement("div"); d.className = "row";
  const a = document.createElement("span"); a.textContent = label;
  const b = document.createElement("span"); if (strong) b.className = "v";
  b.textContent = value; d.append(a, b); return d;
}
const hideTip = () => { tip.style.display = "none"; };

// Sequential ramp interpolation for uncertainty coloring.
function rampColor(t) {
  const stops = ["--seq-100","--seq-250","--seq-400","--seq-550","--seq-700"]
    .map(n => css(n)).map(hex => {
      const h = hex.replace("#",""); return [0,2,4].map(i => parseInt(h.slice(i,i+2),16));
    });
  const x = Math.max(0, Math.min(1, t)) * (stops.length - 1);
  const i = Math.min(Math.floor(x), stops.length - 2), f = x - i;
  const rgb = stops[i].map((v, j) => Math.round(v + f * (stops[i+1][j] - v)));
  return "rgb(" + rgb.join(",") + ")";
}

// ---- 3-D emotion space -------------------------------------------------
let rotX = -0.45, rotY = 0.6;
function renderSpace() {
  const { c, ctx, w, h } = setupCanvas("space");
  const pts = DATA.points;
  const n = pts.pred.length;
  const umin = Math.min(...pts.uncertainty), umax = Math.max(...pts.uncertainty);
  const scale = Math.min(w, h) * 0.33, cx = w / 2, cy = h / 2;
  const cosY = Math.cos(rotY), sinY = Math.sin(rotY);
  const cosX = Math.cos(rotX), sinX = Math.sin(rotX);
  function project(p) {
    let [x, y, z] = p;
    let x1 = x * cosY + z * sinY, z1 = -x * sinY + z * cosY;
    let y1 = y * cosX - z1 * sinX, z2 = y * sinX + z1 * cosX;
    const d = 3.2 / (3.2 + z2);
    return [cx + x1 * scale * d, cy - y1 * scale * d, z2, d];
  }
  // Axes (recessive).
  ctx.strokeStyle = css("--axis"); ctx.lineWidth = 1;
  ctx.fillStyle = css("--text-muted"); ctx.font = "11px system-ui";
  const axes = [[[-1,0,0],[1,0,0],DATA.dims[0]],[[0,-1,0],[0,1,0],DATA.dims[1]],[[0,0,-1],[0,0,1],DATA.dims[2]||""]];
  for (const [a, b, name] of axes) {
    const pa = project(a), pb = project(b);
    ctx.beginPath(); ctx.moveTo(pa[0], pa[1]); ctx.lineTo(pb[0], pb[1]); ctx.stroke();
    if (name) ctx.fillText(name, pb[0] + 4, pb[1]);
  }
  const order = [...Array(n).keys()];
  const projected = order.map(i => project(pts.pred[i]));
  order.sort((a, b) => projected[a][2] - projected[b][2]);  // back-to-front
  const surface = css("--surface-1");
  renderSpace.hit = [];
  for (const i of order) {
    const [px, py, , d] = projected[i];
    const t = umax > umin ? (pts.uncertainty[i] - umin) / (umax - umin) : 0.5;
    const rr = 4 * d;
    ctx.beginPath(); ctx.arc(px, py, rr + 2, 0, 7); ctx.fillStyle = surface; ctx.fill();
    ctx.beginPath(); ctx.arc(px, py, rr, 0, 7); ctx.fillStyle = rampColor(t); ctx.fill();
    renderSpace.hit.push([px, py, i]);
  }
  c.onpointermove = ev => {
    const rect = c.getBoundingClientRect();
    const mx = ev.clientX - rect.left, my = ev.clientY - rect.top;
    if (ev.buttons & 1) {
      rotY += ev.movementX * 0.01; rotX += ev.movementY * 0.01;
      hideTip(); renderSpace(); return;
    }
    let best = null, bd = 26 * 26;
    for (const [px, py, i] of renderSpace.hit) {
      const dd = (px - mx) ** 2 + (py - my) ** 2;
      if (dd < bd) { bd = dd; best = i; }
    }
    if (best == null) { hideTip(); return; }
    const rows = [tipRow("uncertainty", pts.uncertainty[best].toFixed(3), true)];
    DATA.dims.forEach((dname, j) => rows.push(
      tipRow(dname, pts.pred[best][j].toFixed(2) + " (y " + pts.target[best][j].toFixed(2) + ")")));
    showTip(ev, rows);
  };
  c.onpointerleave = hideTip;
}

// ---- line charts ---------------------------------------------------------
function lineChart(id, values, color, yLabel) {
  const { c, ctx, w, h } = setupCanvas(id);
  const vals = (values || []).filter(v => v !== null && v !== undefined)
    .map(Number).filter(v => isFinite(v));
  if (!vals.length) {
    ctx.fillStyle = css("--text-muted"); ctx.font = "12px system-ui";
    ctx.fillText("no history", 12, h / 2); return;
  }
  const padL = 42, padR = 12, padT = 10, padB = 22;
  const lo = Math.min(...vals), hi = Math.max(...vals);
  const span = (hi - lo) || 1;
  const X = i => padL + (w - padL - padR) * (vals.length === 1 ? 0.5 : i / (vals.length - 1));
  const Y = v => padT + (h - padT - padB) * (1 - (v - lo) / span);
  ctx.strokeStyle = css("--grid"); ctx.lineWidth = 1;
  ctx.fillStyle = css("--text-muted"); ctx.font = "10px system-ui"; ctx.textAlign = "right";
  for (let g = 0; g <= 3; g++) {
    const v = lo + span * g / 3, y = Y(v);
    ctx.beginPath(); ctx.moveTo(padL, y); ctx.lineTo(w - padR, y); ctx.stroke();
    ctx.fillText(v.toFixed(Math.abs(span) < 2 ? 2 : 1), padL - 6, y + 3);
  }
  ctx.textAlign = "left";
  ctx.strokeStyle = color; ctx.lineWidth = 2; ctx.lineJoin = "round"; ctx.lineCap = "round";
  ctx.beginPath();
  vals.forEach((v, i) => i ? ctx.lineTo(X(i), Y(v)) : ctx.moveTo(X(i), Y(v)));
  ctx.stroke();
  const last = vals.length - 1;
  ctx.beginPath(); ctx.arc(X(last), Y(vals[last]), 4, 0, 7);
  ctx.fillStyle = color; ctx.fill();
  ctx.strokeStyle = css("--surface-1"); ctx.lineWidth = 2; ctx.stroke();
  ctx.fillStyle = css("--text-secondary"); ctx.font = "11px system-ui";
  ctx.fillText(vals[last].toFixed(3), Math.min(X(last) + 7, w - 40), Y(vals[last]) + 3);
  c.onpointermove = ev => {
    const rect = c.getBoundingClientRect();
    const mx = ev.clientX - rect.left;
    const i = Math.max(0, Math.min(vals.length - 1,
      Math.round((mx - padL) / (w - padL - padR) * (vals.length - 1))));
    renderAllStatic[id]();  // redraw to clear old crosshair
    const ctx2 = c.getContext("2d");
    ctx2.strokeStyle = css("--axis"); ctx2.lineWidth = 1;
    ctx2.beginPath(); ctx2.moveTo(X(i), padT); ctx2.lineTo(X(i), h - padB); ctx2.stroke();
    showTip(ev, [tipRow(yLabel, vals[i].toFixed(4), true), tipRow("epoch", String(i + 1))]);
  };
  c.onpointerleave = () => { hideTip(); renderAllStatic[id](); };
  return () => lineChart(id, values, color, yLabel);
}

// ---- scatter: uncertainty vs error ---------------------------------------
function renderScatter() {
  const { c, ctx, w, h } = setupCanvas("scatter");
  const u = DATA.points.uncertainty, e = DATA.points.error;
  const padL = 42, padR = 12, padT = 10, padB = 28;
  const umin = Math.min(...u), umax = Math.max(...u);
  const emin = Math.min(...e), emax = Math.max(...e);
  const X = v => padL + (w - padL - padR) * ((v - umin) / ((umax - umin) || 1));
  const Y = v => padT + (h - padT - padB) * (1 - (v - emin) / ((emax - emin) || 1));
  ctx.strokeStyle = css("--grid"); ctx.lineWidth = 1;
  ctx.fillStyle = css("--text-muted"); ctx.font = "10px system-ui";
  for (let g = 0; g <= 3; g++) {
    const v = emin + (emax - emin) * g / 3, y = Y(v);
    ctx.beginPath(); ctx.moveTo(padL, y); ctx.lineTo(w - padR, y); ctx.stroke();
    ctx.textAlign = "right"; ctx.fillText(v.toFixed(2), padL - 6, y + 3);
  }
  ctx.textAlign = "center";
  ctx.fillText("uncertainty →", w / 2, h - 8);
  ctx.save(); ctx.translate(12, h / 2); ctx.rotate(-Math.PI / 2);
  ctx.fillText("|error| →", 0, 0); ctx.restore();
  const color = css("--series-1"), surface = css("--surface-1");
  renderScatter.hit = [];
  for (let i = 0; i < u.length; i++) {
    const px = X(u[i]), py = Y(e[i]);
    ctx.beginPath(); ctx.arc(px, py, 5, 0, 7); ctx.fillStyle = surface; ctx.fill();
    ctx.beginPath(); ctx.arc(px, py, 3.5, 0, 7); ctx.fillStyle = color;
    ctx.globalAlpha = 0.75; ctx.fill(); ctx.globalAlpha = 1;
    renderScatter.hit.push([px, py, i]);
  }
  c.onpointermove = ev => {
    const rect = c.getBoundingClientRect();
    const mx = ev.clientX - rect.left, my = ev.clientY - rect.top;
    let best = null, bd = 24 * 24;
    for (const [px, py, i] of renderScatter.hit) {
      const dd = (px - mx) ** 2 + (py - my) ** 2;
      if (dd < bd) { bd = dd; best = i; }
    }
    if (best == null) { hideTip(); return; }
    showTip(ev, [tipRow("|error|", e[best].toFixed(3), true),
                 tipRow("uncertainty", u[best].toFixed(3))]);
  };
  c.onpointerleave = hideTip;
}

// ---- reliability diagram --------------------------------------------------
function renderReliability() {
  const { c, ctx, w, h } = setupCanvas("reliability");
  const rel = DATA.reliability;
  const padL = 42, padR = 12, padT = 10, padB = 28;
  const X = v => padL + (w - padL - padR) * v;
  const Y = v => padT + (h - padT - padB) * (1 - v);
  ctx.strokeStyle = css("--grid"); ctx.lineWidth = 1;
  ctx.fillStyle = css("--text-muted"); ctx.font = "10px system-ui"; ctx.textAlign = "right";
  for (let g = 0; g <= 4; g++) {
    const y = Y(g / 4);
    ctx.beginPath(); ctx.moveTo(padL, y); ctx.lineTo(w - padR, y); ctx.stroke();
    ctx.fillText((g / 4).toFixed(2), padL - 6, y + 3);
  }
  ctx.textAlign = "center"; ctx.fillText("confidence →", w / 2, h - 8);
  // Ideal line.
  ctx.strokeStyle = css("--text-muted"); ctx.lineWidth = 1;
  ctx.setLineDash([]); ctx.beginPath(); ctx.moveTo(X(0), Y(0)); ctx.lineTo(X(1), Y(1)); ctx.stroke();
  // Observed.
  const color = css("--series-1"), surface = css("--surface-1");
  ctx.strokeStyle = color; ctx.lineWidth = 2; ctx.lineJoin = "round";
  ctx.beginPath();
  rel.forEach((b, i) => {
    const px = X(Math.max(0, Math.min(1, b.confidence)));
    const py = Y(Math.max(0, Math.min(1, b.accuracy)));
    i ? ctx.lineTo(px, py) : ctx.moveTo(px, py);
  });
  ctx.stroke();
  renderReliability.hit = [];
  rel.forEach(b => {
    const px = X(Math.max(0, Math.min(1, b.confidence)));
    const py = Y(Math.max(0, Math.min(1, b.accuracy)));
    ctx.beginPath(); ctx.arc(px, py, 6, 0, 7); ctx.fillStyle = surface; ctx.fill();
    ctx.beginPath(); ctx.arc(px, py, 4, 0, 7); ctx.fillStyle = color; ctx.fill();
    renderReliability.hit.push([px, py, b]);
  });
  c.onpointermove = ev => {
    const rect = c.getBoundingClientRect();
    const mx = ev.clientX - rect.left, my = ev.clientY - rect.top;
    let best = null, bd = 24 * 24;
    for (const [px, py, b] of renderReliability.hit) {
      const dd = (px - mx) ** 2 + (py - my) ** 2;
      if (dd < bd) { bd = dd; best = b; }
    }
    if (best == null) { hideTip(); return; }
    showTip(ev, [tipRow("accuracy", best.accuracy.toFixed(3), true),
                 tipRow("confidence", best.confidence.toFixed(3)),
                 tipRow("samples", String(best.count))]);
  };
  c.onpointerleave = hideTip;
}

// ---- per-dimension CCC bars ------------------------------------------------
function renderBars() {
  const { c, ctx, w, h } = setupCanvas("bars");
  const entries = Object.entries(DATA.ccc_per_dim);
  const padL = 42, padR = 12, padT = 12, padB = 26;
  const lo = Math.min(0, ...entries.map(e => e[1]));
  const hi = Math.max(1, ...entries.map(e => e[1]));
  const Y = v => padT + (h - padT - padB) * (1 - (v - lo) / (hi - lo));
  ctx.strokeStyle = css("--grid"); ctx.lineWidth = 1;
  ctx.fillStyle = css("--text-muted"); ctx.font = "10px system-ui"; ctx.textAlign = "right";
  for (let g = 0; g <= 4; g++) {
    const v = lo + (hi - lo) * g / 4, y = Y(v);
    ctx.beginPath(); ctx.moveTo(padL, y); ctx.lineTo(w - padR, y); ctx.stroke();
    ctx.fillText(v.toFixed(2), padL - 6, y + 3);
  }
  const slot = (w - padL - padR) / entries.length;
  const bw = Math.min(24, slot * 0.5);
  const color = css("--series-1");
  renderBars.hit = [];
  entries.forEach(([name, v], i) => {
    const x = padL + slot * (i + 0.5) - bw / 2;
    const y0 = Y(Math.max(0, lo)), y1 = Y(v);
    const top = Math.min(y0, y1), bh = Math.max(2, Math.abs(y0 - y1));
    ctx.fillStyle = color;
    ctx.beginPath();
    ctx.roundRect(x, top, bw, bh, v >= 0 ? [4, 4, 0, 0] : [0, 0, 4, 4]);
    ctx.fill();
    ctx.fillStyle = css("--text-secondary"); ctx.font = "11px system-ui"; ctx.textAlign = "center";
    ctx.fillText(v.toFixed(3), x + bw / 2, top - 5);
    ctx.fillStyle = css("--text-muted");
    ctx.fillText(name, x + bw / 2, h - 8);
    renderBars.hit.push([x, top, bw, bh, name, v]);
  });
  c.onpointermove = ev => {
    const rect = c.getBoundingClientRect();
    const mx = ev.clientX - rect.left, my = ev.clientY - rect.top;
    const hitPad = 8;
    const hitItem = renderBars.hit.find(([x, top, bw2, bh]) =>
      mx >= x - hitPad && mx <= x + bw2 + hitPad && my >= top - hitPad && my <= top + bh + hitPad);
    if (!hitItem) { hideTip(); return; }
    showTip(ev, [tipRow("CCC", hitItem[5].toFixed(4), true), tipRow("dimension", hitItem[4])]);
  };
  c.onpointerleave = hideTip;
}

// Table view (accessibility: values reachable without hover).
(function table() {
  const t = document.getElementById("table");
  const head = document.createElement("tr");
  ["dimension", "CCC"].forEach(s => {
    const th = document.createElement("th"); th.textContent = s; head.append(th);
  });
  t.append(head);
  for (const [name, v] of Object.entries(DATA.ccc_per_dim)) {
    const tr = document.createElement("tr");
    const a = document.createElement("td"); a.textContent = name;
    const b = document.createElement("td"); b.textContent = v.toFixed(4);
    tr.append(a, b); t.append(tr);
  }
})();

const renderAllStatic = {};
function renderAll() {
  renderSpace();
  renderAllStatic["loss"] = lineChart("loss", DATA.history.train_loss, css("--series-2"), "loss");
  renderAllStatic["ccc"] = lineChart("ccc", DATA.history.val_ccc, css("--series-1"), "val CCC");
  renderScatter();
  renderReliability();
  renderBars();
}
renderAll();
window.addEventListener("resize", renderAll);
</script>
</body>
</html>
"""
