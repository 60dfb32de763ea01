/* ImageProcessor web UI.
 *
 * Functional equivalent of the reference SPA (upload with operation flags,
 * status polling, per-operation view/download, delete) re-implemented from
 * scratch. Polls /api/images/{id}/status every 5 s for pending items, like
 * the reference (static/js/app.js:4).
 */
"use strict";

const POLL_INTERVAL_MS = 5000;
const MAX_UPLOAD = 32 * 1024 * 1024;
const OPERATIONS = ["thumbnail", "resize", "watermark"];

const el = (id) => document.getElementById(id);

// Localized status labels (reference app.js:518-527 ships RU text; the
// badge CSS class keeps the raw wire status).
const STATUS_TEXT = {
  uploaded: "Загружено",
  processing: "Обрабатывается",
  completed: "Готово",
  failed: "Ошибка",
  deleted: "Удалено",
};
const statusText = (s) => STATUS_TEXT[s] || s;

class ImageBoard {
  constructor() {
    this.items = new Map(); // id -> {id, filename, status, size, created_at}
    this.bindUpload();
    this.refresh();
    setInterval(() => {
      this.pollPending();
      this.refresh(); // recovers a failed initial load; sees other clients
    }, POLL_INTERVAL_MS);
  }

  bindUpload() {
    const form = el("upload-form");
    const fileInput = el("file");
    const wm = el("watermark");
    wm.addEventListener("change", () => {
      el("watermarkText").disabled = !wm.checked;
    });
    fileInput.addEventListener("change", () => this.preview(fileInput));
    const zone = el("dropzone");
    zone.addEventListener("dragover", (e) => {
      e.preventDefault();
      zone.classList.add("drag");
    });
    zone.addEventListener("dragleave", () => zone.classList.remove("drag"));
    zone.addEventListener("drop", (e) => {
      e.preventDefault();
      zone.classList.remove("drag");
      if (e.dataTransfer.files.length) {
        fileInput.files = e.dataTransfer.files;
        this.preview(fileInput);
      }
    });
    form.addEventListener("submit", (e) => {
      e.preventDefault();
      this.upload(fileInput);
    });
  }

  preview(fileInput) {
    const file = fileInput.files[0];
    const img = el("preview");
    if (!file) { img.hidden = true; return; }
    el("drop-label").textContent = `${file.name} (${fmtSize(file.size)})`;
    if (img.src.startsWith("blob:")) URL.revokeObjectURL(img.src);
    img.src = URL.createObjectURL(file);
    img.hidden = false;
  }

  async upload(fileInput) {
    const file = fileInput.files[0];
    const msg = el("upload-msg");
    if (!file) { msg.textContent = "Choose a file first."; return; }
    if (file.size > MAX_UPLOAD) {
      msg.textContent = "File exceeds the 32 MiB limit.";
      return;
    }
    // Dedup guard (reference app.js:35-138): ignore re-submits while an
    // upload is in flight, and skip files already uploaded this session
    // (same name + size).
    if (this.uploading) return;
    const dupKey = `${file.name}:${file.size}`;
    if (this.uploaded && this.uploaded.has(dupKey)) {
      msg.textContent = `${file.name} was already uploaded.`;
      return;
    }
    this.uploading = true;
    const fd = new FormData();
    fd.append("file", file);
    for (const op of ["thumbnail", "resize", "watermark"]) {
      if (el(op).checked) fd.append(op, "true");
    }
    const text = el("watermarkText").value.trim();
    if (el("watermark").checked && text) fd.append("watermark_text", text);

    el("upload-btn").disabled = true;
    msg.textContent = "Uploading…";
    try {
      const r = await fetch("/api/images/upload", { method: "POST", body: fd });
      const body = await r.json();
      if (!r.ok) throw new Error(body.message || r.statusText);
      msg.textContent = `Queued ${body.filename} — processing…`;
      (this.uploaded ||= new Set()).add(dupKey);
      this.items.set(body.id, body);
      this.touch(body.id);
      this.render();
    } catch (err) {
      msg.textContent = `Upload failed: ${err.message}`;
    } finally {
      this.uploading = false;
      el("upload-btn").disabled = false;
    }
  }

  async refresh() {
    try {
      const fetchStart = Date.now();
      const r = await fetch("/api/images?limit=100");
      if (!r.ok) return;
      const fresh = await r.json();
      const present = new Set(fresh.map((it) => it.id));
      let changed = false;
      // prune rows deleted elsewhere (another tab) or pushed past the
      // list window -- but NOT rows touched locally after the fetch
      // started (an upload resolving mid-fetch is absent from the
      // server's stale snapshot and would flicker away for 5 s)
      for (const id of [...this.items.keys()]) {
        if (!present.has(id)
            && (this.touched?.get(id) ?? 0) < fetchStart) {
          this.items.delete(id);
          changed = true;
        }
      }
      for (const item of fresh) {
        // a status pollPending advanced after the fetch started is
        // fresher than this snapshot; keep it
        if ((this.touched?.get(item.id) ?? 0) >= fetchStart) continue;
        const prev = this.items.get(item.id);
        if (!prev || prev.status !== item.status) changed = true;
        this.items.set(item.id, item);
      }
      // re-render only on actual change: an unconditional rebuild every
      // 5 s wipes selection/focus and drops clicks mid-rebuild
      if (changed) this.render();
    } catch { /* server unreachable; retry on next poll */ }
  }

  touch(id) {
    (this.touched ||= new Map()).set(id, Date.now());
  }

  pollPending() {
    for (const item of this.items.values()) {
      if (item.status === "processing" || item.status === "uploaded") {
        fetch(`/api/images/${item.id}/status`)
          .then((r) => {
            if (r.status === 404) { // deleted elsewhere: stop polling it
              this.items.delete(item.id);
              this.render();
              return null;
            }
            return r.ok ? r.json() : null;
          })
          .then((s) => {
            if (s && s.status !== item.status) {
              item.status = s.status;
              this.touch(item.id);
              this.render();
            }
          })
          .catch(() => {});
      }
    }
  }

  async remove(id) {
    if (!confirm("Delete this image and all processed versions?")) return;
    let r;
    try {
      r = await fetch(`/api/images/${id}`, { method: "DELETE" });
    } catch {
      alert("Delete failed: server unreachable");
      return;
    }
    if (r.status === 204 || r.status === 404) {
      // 404 = already deleted elsewhere; drop the row either way and
      // free the dedup slot so the same file can be re-uploaded
      const item = this.items.get(id);
      if (item && this.uploaded) {
        this.uploaded.delete(`${item.filename}:${item.size}`);
      }
      this.items.delete(id);
      this.render();
    } else {
      alert(`Delete failed (HTTP ${r.status})`);
    }
  }

  render() {
    const list = el("image-list");
    list.innerHTML = "";
    const items = [...this.items.values()].sort(
      (a, b) => (b.created_at || "").localeCompare(a.created_at || ""));
    if (!items.length) {
      list.innerHTML = '<p class="empty">No images yet.</p>';
      return;
    }
    for (const item of items) {
      const row = document.createElement("div");
      row.className = "image-row";
      const ops = OPERATIONS.map((op) =>
        `<button data-id="${item.id}" data-op="${op}" class="op-btn">
           ${op}</button>`).join("");
      row.innerHTML = `
        <div class="row-main">
          <span class="name">${escapeHtml(item.filename)}</span>
          <span class="badge ${item.status}">${statusText(item.status)}</span>
          <span class="size">${fmtSize(item.size)}</span>
        </div>
        <div class="row-actions">
          <button data-id="${item.id}" data-op="" class="op-btn">original
          </button>
          ${item.status === "completed" ? ops : ""}
          <button data-id="${item.id}" class="delete-btn">delete</button>
        </div>`;
      list.appendChild(row);
    }
    list.querySelectorAll(".op-btn").forEach((b) =>
      b.addEventListener("click", () => this.view(b.dataset.id, b.dataset.op)));
    list.querySelectorAll(".delete-btn").forEach((b) =>
      b.addEventListener("click", () => this.remove(b.dataset.id)));
  }

  async view(id, op) {
    const url = op ? `/api/images/${id}?operation=${op}` : `/api/images/${id}`;
    let r;
    try {
      r = await fetch(url);
    } catch {
      alert("Server unreachable");
      return;
    }
    if (!r.ok) {
      alert(op ? "Processed version not found (still processing?)"
               : "Image not found");
      return;
    }
    const blob = await r.blob();
    const prev = el("modal-img").src;
    if (prev.startsWith("blob:")) URL.revokeObjectURL(prev);
    const obj = URL.createObjectURL(blob);
    el("modal-img").src = obj;
    const dl = el("modal-download");
    dl.href = obj;
    dl.download = op ? `${id}_${op}` : id;
    el("modal").hidden = false;
  }
}

function fmtSize(n) {
  if (n == null) return "";
  if (n > 1 << 20) return `${(n / (1 << 20)).toFixed(1)} MiB`;
  if (n > 1 << 10) return `${(n / (1 << 10)).toFixed(1)} KiB`;
  return `${n} B`;
}

function escapeHtml(s) {
  const d = document.createElement("div");
  d.textContent = s || "";
  return d.innerHTML;
}

el("modal-close").addEventListener("click", () => {
  el("modal").hidden = true;
});
el("modal").addEventListener("click", (e) => {
  if (e.target.id === "modal") el("modal").hidden = true;
});

new ImageBoard();
