/* style_transfer_tpu_torch live preview client (dependency-free).
 *
 * Connects to /websocket for STIterate stats and refreshes /image with a
 * double-buffered, throttled reload so the preview never flickers or
 * hammers the server. Iteration rate is a decayed moving average.
 */
"use strict";

const els = {
  status: document.getElementById("status"),
  size: document.getElementById("size"),
  iter: document.getElementById("iter"),
  loss: document.getElementById("loss"),
  rate: document.getElementById("rate"),
  ram: document.getElementById("ram"),
  preview: document.getElementById("preview"),
};

// Decayed average of iteration wall-time -> it/s.
const rate = {
  last: null, avg: null, decay: 0.9,
  update(t) {
    if (this.last !== null) {
      const dt = t - this.last;
      this.avg = this.avg === null ? dt : this.decay * this.avg + (1 - this.decay) * dt;
    }
    this.last = t;
  },
  get itPerSec() { return this.avg ? 1 / this.avg : null; },
};

let loading = false;
let lastLoad = 0;
const MIN_RELOAD_MS = 100;

function reloadImage(final) {
  const now = Date.now();
  if (!final && (loading || now - lastLoad < MIN_RELOAD_MS)) return;
  loading = true;
  lastLoad = now;
  const img = new Image();
  img.onload = () => {
    els.preview.src = img.src;
    loading = false;
  };
  img.onerror = () => { loading = false; };
  img.src = "/image?t=" + now;
}

function fmtBytes(n) {
  if (!n) return "";
  const units = ["B", "KiB", "MiB", "GiB"];
  let i = 0;
  while (n >= 1024 && i < units.length - 1) { n /= 1024; i++; }
  return n.toFixed(i ? 1 : 0) + " " + units[i];
}

function onIterate(msg) {
  rate.update(msg.time);
  // Display at CSS size w/dpr so the preview is crisp on hi-DPI screens
  // without growing past its natural size (DPR capped at 2, as the
  // reference client does).
  const dpr = Math.min(window.devicePixelRatio || 1, 2);
  els.preview.style.width = `${msg.w / dpr}px`;
  els.preview.style.height = `${msg.h / dpr}px`;
  els.size.innerHTML = `size <b>${msg.w}&times;${msg.h}</b>`;
  els.iter.innerHTML = `iteration <b>${msg.i}/${msg.i_max}</b>`;
  els.loss.innerHTML = `loss <b>${Number(msg.loss).toPrecision(6)}</b>`;
  const r = rate.itPerSec;
  if (r) els.rate.innerHTML = `<b>${r.toFixed(2)}</b> it/s`;
  if (msg.gpu_ram) els.ram.innerHTML = `HBM <b>${fmtBytes(msg.gpu_ram)}</b>`;
  reloadImage(false);
}

function connect() {
  const proto = location.protocol === "https:" ? "wss:" : "ws:";
  const ws = new WebSocket(`${proto}//${location.host}/websocket`);
  ws.onopen = () => { els.status.textContent = "running"; };
  ws.onmessage = (ev) => {
    const msg = JSON.parse(ev.data);
    if (msg._type === "STIterate") onIterate(msg);
    else if (msg._type === "WIDone") {
      els.status.textContent = "finished";
      reloadImage(true);
      ws.close();
    }
  };
  ws.onclose = () => {
    if (els.status.textContent === "running") {
      els.status.textContent = "disconnected — retrying";
      setTimeout(connect, 2000);
    }
  };
}

connect();
reloadImage(true);
